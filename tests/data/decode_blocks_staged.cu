// Test data: the block decoder as it was before the windowed design (one warp,
// the whole compressed row staged in shared memory, output moved in device
// memory), whose phases tools/profile_decode.py also knows ("staged" layout).

// Snappy block decoder for Hopper (sm_90a): one warp per headerless tag stream.
//
// Replaces snappy_tpu/ops/pallas_decode.py::_decode_kernel (and its parse_cmds
// prepass). It keeps that kernel's contract and none of its TPU layout:
//   in:  comp u8[B, C] (row b holds clens[b] bytes, C >= clen + 4),
//        clens i32[B], ulens i32[B] (<= out_size)
//   out: out u8[B, out_size], ok u8[B] (bool), total i32[B].
// A row that decodes holds its bytes and zeros past total; a row that does
// not is all zero and its total is not specified. The rules are those of the
// plain version, ops/decode_torch.py, which this kernel matches bit for bit:
// the walk stops when fewer than 2 bytes remain; a tag or its trailer past
// clen, a copy offset of 0 or beyond the output so far, output past ulen, and
// a final length other than ulen are corrupt.
//
// What bounds it on the card: the serial per-tag latency of one warp. Each
// tag's position depends on the previous tag's length and a copy reads bytes
// that earlier tags wrote, so a stream is one dependent chain of a few
// shared-memory loads and a short move per tag; the bytes moved are few
// (each output byte is written once; a copied byte is also read once from
// earlier output). The design
// answers only the first-order part:
// the compressed row is staged in shared memory with a coalesced copy, so the
// dependent tag loads hit shared memory and not L2; all 32 lanes parse the
// same tag (broadcast reads, no shuffles) and split the byte move, a copy as
// out[op + j] = out[op - f + (j mod f)], which makes every copy, RLE included,
// lane-parallel with no inner chain. Making it fast (several streams per
// warp, output staged in shared memory, tags prefetched ahead of the walk)
// comes in later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCompPad = 4;
constexpr int kWarp = 32;

// Tag-decode LUT entry of tag byte c, computed rather than loaded (all lanes
// take the same branch): bits 0..7 length, 8..10 copy offset high bits
// pre-shifted, 11..13 number of trailer bytes. Same table as
// snappy_tpu_torch/core/constants.py::CHAR_TABLE.
__device__ __forceinline__ uint32_t tag_entry(uint32_t c) {
  const uint32_t hi6 = c >> 2;
  switch (c & 3u) {
    case 0:
      return hi6 < 60 ? hi6 + 1 : (1u | ((hi6 - 59) << 11));
    case 1:
      return (4 + (hi6 & 7u)) | (((c >> 5) & 7u) << 8) | (1u << 11);
    case 2:
      return (hi6 + 1) | (2u << 11);
    default:
      return (hi6 + 1) | (4u << 11);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWarp)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                     const int32_t* __restrict__ ulens, int64_t row_c, int64_t out_size,
                     uint8_t* out, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ total_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = comp + row * row_c;
  uint8_t* dst = out + row * out_size;

  int64_t clen = clens[row];
  int64_t ulen = ulens[row];
  // The wrapper does not read the lengths (that would wait for the stream):
  // a row whose lengths do not fit decodes nothing and comes back not ok and
  // all zero, reading or writing nothing outside its own row.
  bool ok = clen >= 0 && clen <= row_c - kCompPad && ulen >= 0 && ulen <= out_size;
  if (!ok) clen = ulen = 0;

  const uint8_t* in = src;
  if (kStaged) {
    // Coalesced 16-byte loads where the row is aligned, bytes for the rest.
    int64_t head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int64_t n16 = clen >> 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(smem);
      for (int64_t i = lane; i < n16; i += kWarp) d4[i] = s4[i];
      head = n16 << 4;
    }
    for (int64_t i = head + lane; i < clen; i += kWarp) smem[i] = src[i];
    __syncwarp();
    in = smem;
  }

  int64_t ip = 0, op = 0;
  // Every lane walks the same tags, so all control flow is warp-uniform.
  while (ok && ip + 1 < clen) {
    const uint32_t c = in[ip];
    const uint32_t entry = tag_entry(c);
    const int64_t taglen = entry >> 11;
    const int64_t tag_end = ip + 1 + taglen;
    if (tag_end > clen) {
      ok = false;
      break;
    }
    uint32_t trailer = 0;
    for (int k = 0; k < taglen; ++k) trailer |= uint32_t(in[ip + 1 + k]) << (8 * k);
    const int64_t len = entry & 0xFF;
    if (c & 3u) {
      const int64_t f = int64_t(entry & 0x700) + trailer;
      if (f == 0 || f > op || op + len > ulen) {
        ok = false;
        break;
      }
      const int64_t base = op - f;
      for (int64_t j = lane; j < len; j += kWarp) {
        dst[op + j] = dst[base + (f >= len ? j : j % f)];
      }
      op += len;
      ip = tag_end;
    } else {
      const int64_t lit = len + int64_t(trailer);
      if (tag_end + lit > clen || op + lit > ulen) {
        ok = false;
        break;
      }
      for (int64_t j = lane; j < lit; j += kWarp) dst[op + j] = in[tag_end + j];
      op += lit;
      ip = tag_end + lit;
    }
    // Lanes read bytes other lanes wrote for earlier tags.
    __syncwarp();
  }
  __syncwarp();
  ok = ok && op == ulen;
  // Zero what the row does not hold: past total, or all of it on failure.
  for (int64_t j = (ok ? op : 0) + lane; j < out_size; j += kWarp) dst[j] = 0;
  if (lane == 0) {
    ok_out[row] = ok ? 1 : 0;
    total_out[row] = static_cast<int32_t>(op);
  }
}

}  // namespace

extern "C" {

// Launch the decoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_decode_blocks(const void* comp, const void* clens, const void* ulens,
                              int64_t rows, int64_t row_c, int64_t out_size, void* out,
                              void* ok, void* total, void* stream) {
  if (rows <= 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int64_t smem = (row_c + 15) & ~int64_t(15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c8 = static_cast<const uint8_t*>(comp);
  const auto* cl = static_cast<const int32_t*>(clens);
  const auto* ul = static_cast<const int32_t*>(ulens);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* ok8 = static_cast<uint8_t*>(ok);
  auto* t32 = static_cast<int32_t*>(total);
  if (smem <= smem_optin) {
    err = cudaFuncSetAttribute(decode_blocks_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    decode_blocks_kernel<true><<<dim3(unsigned(rows)), kWarp, size_t(smem), s>>>(
        c8, cl, ul, row_c, out_size, o8, ok8, t32);
  } else {
    // A row wider than shared memory (a long unsegmentable raw stream) is
    // read from device memory directly.
    decode_blocks_kernel<false><<<dim3(unsigned(rows)), kWarp, 0, s>>>(
        c8, cl, ul, row_c, out_size, o8, ok8, t32);
  }
  return cudaGetLastError();
}

const char* snappy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
