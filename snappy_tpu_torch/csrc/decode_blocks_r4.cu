// Snappy block decoder for Hopper (sm_90a) after the pinned round-4 design:
// a chunked walk into record arrays, then drains. One thread block per
// headerless tag stream.
//
// Replaces snappy_tpu/ops/pallas_decode_r4.py::_decode_kernel (and its
// parse_cmds prepass), K3. It keeps K3's contract and its narrower envelope,
// and none of its TPU layout (128-lane int32 rows, SMEM command words,
// masked stores and rolls):
//   in:  comp u8[B, C] (row b holds clens[b] bytes, C >= clen + 4),
//        clens i32[B], ulens i32[B] (<= out_size)
//   out: out u8[B, out_size], ok u8[B] (bool), total i32[B].
// The rules are those of the plain version, ops/decode_torch.py::
// decode_blocks_r4, which this kernel matches bit for bit: a tag or its
// trailer past clen, a copy offset of 0, above 0xFFFF or beyond the output
// so far, a literal over 65,536 bytes, output past ulen, and a final length
// other than ulen are corrupt; a byte left after the last tag is read as a
// tag and so is corrupt too. A row that decodes holds its bytes and zeros
// past total; a row that does not is all zero, its total not specified.
//
// The design, per chunk of up to kChunk records:
//   walk     thread 0 parses tags from (ip, op) and records each as a
//            literal (src in the compressed row, op, n) or a copy (op, f, n)
//            in shared memory. A 64-byte COPY_2 and the COPY_1/COPY_2 of the
//            same offset right after it fold into one record, as K3's
//            prepass folds them (pallas_decode_r4.py:212-251): the bytes are
//            those of the two copies, the record count drops.
//   literals every warp takes records in turn and moves them whole: their
//            sources are the compressed row, which is never written, so they
//            run in any order.
//   copies   ordered groups of kGroup records. All warps move the records
//            whose source lies before the group's first output position
//            (written by now); the others, whose source reaches at or past
//            it, run after the group, in order, by one warp. A copy moves
//            out[op + j] = out[op - f + (j mod f)], which reads only bytes
//            before op, so overlapping (RLE) copies need no inner chain.
// What bounds it on the card: the walk, a serial chain of dependent
// shared-memory loads by one thread per stream, while the block's other
// warps wait at the barrier; the bytes moved are few (each output byte
// written once, each literal or copied byte read once). The compressed row
// and, where it fits, the output are staged in shared memory so the walk
// and the copies' reads stay on chip.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SNAPPY_R4_THREADS
#define SNAPPY_R4_THREADS 256
#endif

namespace {

constexpr int kCompPad = 4;
constexpr int kThreads = SNAPPY_R4_THREADS;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kChunk = 1024;  // records per walk, as K3's CHUNK
constexpr int kGroup = 16;    // copies per ordered drain group, as K3's GROUP
constexpr int64_t kMaxOffset = 0xFFFF;
constexpr int64_t kMaxLiteral = 0x10000;
// Shared memory: six int32 record arrays of kChunk, then the walk's state
// (ip, op, literal records, copy records, ok, done), then the staged rows.
constexpr int64_t kRecordBytes = 6 * kChunk * 4;
constexpr int64_t kStateBytes = 8 * 8;
constexpr int64_t kHeadBytes = kRecordBytes + kStateBytes;
static_assert(kThreads % kWarp == 0 && kWarps >= 1, "whole warps only");
static_assert(kHeadBytes % 16 == 0, "staged rows stay 16-byte aligned");

__host__ __device__ __forceinline__ int64_t round16(int64_t n) { return (n + 15) & ~int64_t(15); }

// Tag-decode LUT entry of tag byte c, as in decode_blocks.cu: bits 0..7
// length, 8..10 copy offset high bits pre-shifted, 11..13 trailer bytes.
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

// Walk up to kChunk records of one stream from st[0] (ip), st[1] (op), by
// one thread. Leaves ip, op, the record counts, ok and done in st.
__device__ void walk_chunk(const uint8_t* in, int64_t clen, int64_t ulen, int32_t* lit_src,
                           int32_t* lit_op, int32_t* lit_n, int32_t* cp_op, int32_t* cp_f,
                           int32_t* cp_n, int64_t* st) {
  int64_t ip = st[0], op = st[1];
  int nl = 0, nc = 0;
  bool ok = true, done = false, fold_open = false;
  int64_t fold_f = 0;
  while (nl + nc < kChunk) {
    if (ip >= clen) {
      done = true;
      break;
    }
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
      if (f == 0 || f > op || f > kMaxOffset || op + len > ulen) {
        ok = false;
        break;
      }
      if (fold_open && f == fold_f && (c & 3u) != 3u) {
        cp_n[nc - 1] += int32_t(len);
        fold_open = false;
      } else {
        cp_op[nc] = int32_t(op);
        cp_f[nc] = int32_t(f);
        cp_n[nc] = int32_t(len);
        ++nc;
        fold_open = (c & 3u) == 2u && len == 64;
        fold_f = f;
      }
      op += len;
      ip = tag_end;
    } else {
      const int64_t lit = len + int64_t(trailer);
      if (lit > kMaxLiteral || tag_end + lit > clen || op + lit > ulen) {
        ok = false;
        break;
      }
      lit_src[nl] = int32_t(tag_end);
      lit_op[nl] = int32_t(op);
      lit_n[nl] = int32_t(lit);
      ++nl;
      fold_open = false;
      op += lit;
      ip = tag_end + lit;
    }
  }
  st[0] = ip;
  st[1] = op;
  st[2] = nl;
  st[3] = nc;
  st[4] = ok;
  st[5] = done;
}

// One past the last source byte a copy reads: out[op - f + (j mod f)] for
// j < n reads [op - f, op - f + min(n, f)).
__device__ __forceinline__ int64_t copy_reach(int64_t op, int64_t f, int64_t n) {
  return op - f + (n < f ? n : f);
}

// The copy's bytes moved by the lanes of one warp.
__device__ __forceinline__ void move_copy(uint8_t* dst, int64_t op, int64_t f, int64_t n, int lane) {
  const int64_t base = op - f;
  for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = dst[base + (f >= n ? j : j % f)];
}

template <bool kStageComp, bool kStageOut>
__global__ void __launch_bounds__(kThreads)
decode_blocks_r4_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                        const int32_t* __restrict__ ulens, int64_t row_c, int64_t out_size,
                        uint8_t* out, uint8_t* __restrict__ ok_out,
                        int32_t* __restrict__ total_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* lit_src = reinterpret_cast<int32_t*>(smem);
  int32_t* lit_op = lit_src + kChunk;
  int32_t* lit_n = lit_op + kChunk;
  int32_t* cp_op = lit_n + kChunk;
  int32_t* cp_f = cp_op + kChunk;
  int32_t* cp_n = cp_f + kChunk;
  int64_t* st = reinterpret_cast<int64_t*>(smem + kRecordBytes);
  uint8_t* comp_s = smem + kHeadBytes;
  uint8_t* out_s = comp_s + (kStageComp ? round16(row_c) : 0);

  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const uint8_t* src = comp + row * row_c;
  uint8_t* dst_g = out + row * out_size;

  int64_t clen = clens[row];
  int64_t ulen = ulens[row];
  // The wrapper does not read the lengths (that would wait for the stream):
  // a row whose lengths do not fit decodes nothing and comes back not ok and
  // all zero, reading or writing nothing outside its own row.
  const bool fits = clen >= 0 && clen <= row_c - kCompPad && ulen >= 0 && ulen <= out_size;
  if (!fits) clen = ulen = 0;

  const uint8_t* in = src;
  if (kStageComp) {
    int64_t head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int64_t n16 = clen >> 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(comp_s);
      for (int64_t i = tid; i < n16; i += kThreads) d4[i] = s4[i];
      head = n16 << 4;
    }
    for (int64_t i = head + tid; i < clen; i += kThreads) comp_s[i] = src[i];
    in = comp_s;
  }
  uint8_t* dst = kStageOut ? out_s : dst_g;
  if (tid == 0) {
    st[0] = 0;
    st[1] = 0;
    st[4] = fits;
    st[5] = 0;
  }
  __syncthreads();

  bool more = fits;
  while (more) {
    if (tid == 0) walk_chunk(in, clen, ulen, lit_src, lit_op, lit_n, cp_op, cp_f, cp_n, st);
    __syncthreads();
    // Every thread reads the walk's result before the next barrier; thread
    // 0 writes st again only after it.
    const int n_lit = int(st[2]), n_cpy = int(st[3]);
    const bool chunk_ok = st[4] != 0;
    more = chunk_ok && st[5] == 0;
    if (!chunk_ok) break;

    for (int t = warp; t < n_lit; t += kWarps) {
      const int64_t s = lit_src[t], op = lit_op[t], n = lit_n[t];
      for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = in[s + j];
    }
    __syncthreads();

    for (int g = 0; g < n_cpy; g += kGroup) {
      const int end = g + kGroup < n_cpy ? g + kGroup : n_cpy;
      const int64_t lead = cp_op[g];
      bool any_after = false;
      for (int k = g; k < end; ++k) {
        const int64_t op = cp_op[k], f = cp_f[k], n = cp_n[k];
        const bool after = copy_reach(op, f, n) > lead;
        any_after |= after;
        if (!after && (k - g) % kWarps == warp) move_copy(dst, op, f, n, lane);
      }
      __syncthreads();
      if (any_after) {
        if (warp == 0) {
          for (int k = g; k < end; ++k) {
            const int64_t op = cp_op[k], f = cp_f[k], n = cp_n[k];
            if (copy_reach(op, f, n) <= lead) continue;
            move_copy(dst, op, f, n, lane);
            // Later copies of the group may read these bytes.
            __syncwarp();
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();

  const int64_t op = st[1];
  const bool ok = st[4] != 0 && op == ulen;
  const int64_t keep = ok ? op : 0;
  if (kStageOut) {
    // Write the staged row out, zero from `keep` on.
    if ((reinterpret_cast<uintptr_t>(dst_g) & 15) == 0) {
      const int64_t n16 = out_size >> 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(out_s);
      uint4* d4 = reinterpret_cast<uint4*>(dst_g);
      for (int64_t i = tid; i < n16; i += kThreads) {
        const int64_t b = i << 4;
        if (b + 16 <= keep) {
          d4[i] = s4[i];
        } else if (b >= keep) {
          d4[i] = uint4{0, 0, 0, 0};
        } else {
          for (int64_t j = b; j < b + 16; ++j) dst_g[j] = j < keep ? out_s[j] : 0;
        }
      }
      for (int64_t j = (n16 << 4) + tid; j < out_size; j += kThreads) dst_g[j] = j < keep ? out_s[j] : 0;
    } else {
      for (int64_t j = tid; j < out_size; j += kThreads) dst_g[j] = j < keep ? out_s[j] : 0;
    }
  } else {
    for (int64_t j = keep + tid; j < out_size; j += kThreads) dst_g[j] = 0;
  }
  if (tid == 0) {
    ok_out[row] = ok ? 1 : 0;
    total_out[row] = static_cast<int32_t>(op);
  }
}

}  // namespace

extern "C" {

// Launch the decoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_decode_blocks_r4(const void* comp, const void* clens, const void* ulens,
                                 int64_t rows, int64_t row_c, int64_t out_size, void* out,
                                 void* ok, void* total, void* stream) {
  if (rows <= 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* c8 = static_cast<const uint8_t*>(comp);
  const auto* cl = static_cast<const int32_t*>(clens);
  const auto* ul = static_cast<const int32_t*>(ulens);
  auto* o8 = static_cast<uint8_t*>(out);
  auto* ok8 = static_cast<uint8_t*>(ok);
  auto* t32 = static_cast<int32_t*>(total);
  // Stage the compressed row, and the output where it fits too; a row wider
  // than shared memory (a long unsegmentable raw stream) stays in device
  // memory, as in decode_blocks.cu.
  const int64_t both = kHeadBytes + round16(row_c) + round16(out_size);
  const int64_t comp_only = kHeadBytes + round16(row_c);
  void (*kernel)(const uint8_t*, const int32_t*, const int32_t*, int64_t, int64_t, uint8_t*,
                 uint8_t*, int32_t*);
  int64_t smem;
  if (both <= smem_optin) {
    kernel = decode_blocks_r4_kernel<true, true>;
    smem = both;
  } else if (comp_only <= smem_optin) {
    kernel = decode_blocks_r4_kernel<true, false>;
    smem = comp_only;
  } else {
    kernel = decode_blocks_r4_kernel<false, false>;
    smem = kHeadBytes;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(rows)), kThreads, size_t(smem), s>>>(c8, cl, ul, row_c, out_size, o8,
                                                              ok8, t32);
  return cudaGetLastError();
}

}  // extern "C"
