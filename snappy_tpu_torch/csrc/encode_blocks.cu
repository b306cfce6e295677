// Snappy block encoder for Hopper (sm_90a): one thread block per 64 KiB block.
//
// Replaces snappy_tpu/ops/pallas_encode.py::_encode_kernel (with its XLA
// prepass candidate_cmds), run with contest=False. It keeps that kernel's
// output byte for byte and none of its TPU layout:
//   in:  blocks u8[B, W] (row b holds blens[b] bytes, W >= blen + 8,
//        W - 8 <= 65536), blens i32[B], min_profit
//   out: out u8[B, out_w] (the headerless tag stream, zero past olens),
//        olens i32[B].
// A row whose blen lies outside [0, W - 8] comes back with olens = -1 and
// all zero. The rules are those of the plain version, ops/encode_torch.py:
// a position p <= blen - 4 whose 4-byte key is not 0xFFFFFFFF takes the
// better of its two most recent earlier equal keys (score: 4 plus the
// leading equal bytes of the next four, minus the copy tag's 2 or 3 bytes;
// ties to the farther one) where that score reaches min_profit; the walk
// emits a literal and the longest copy at each take and resumes at the
// first take at or after the copy's end.
//
// What bounds it on the card: the walk. Each take depends on where the
// previous copy ended, so a block is one dependent chain of a few shared-
// memory round trips per take (find the next take, extend the match, write
// the tags), several thousand takes for a text block, run by one warp while
// the block's other warps wait; and the 224 KiB of shared memory a block
// needs leaves one block per SM. The design answers only the first-order
// part: the row, its hash chain and its take words stay in shared memory,
// so every step of the walk reads shared memory and only the output goes
// to device memory; the candidate pass, which has no chain, runs on all
// 1024 threads; the walk finds the next take and the match end 32 positions
// at a time with a warp ballot, and the warp splits each literal's bytes.
// Making it fast (several blocks per SM with the take words in device
// memory, a walk that overlaps blocks) comes in later work.
//
// Shared memory, 229,392 bytes of the 232,448 a block may have:
//   row   u8[65552]   the block, zero from blen on
//   link  u16[65536]  first the hash chain (the previous position with the
//                     same 14-bit hash), then each position's take
//                     distance (0: no take)
//   head  u16[16384]  the newest position of each hash, while the chain
//                     is built; then the output length of the row
// Candidates are exact: a chain is walked comparing full keys, so a chain
// of colliding keys makes a position slow, never wrong.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SNAPPY_ENC_THREADS
#define SNAPPY_ENC_THREADS 1024
#endif

constexpr int kThreads = SNAPPY_ENC_THREADS;
constexpr int kWarp = 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int64_t kEncPad = 8;
constexpr int64_t kMaxBlock = 1 << 16;
constexpr int64_t kBlockMaxOut = 32 + kMaxBlock + kMaxBlock / 6;
constexpr int kHashBits = 14;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint16_t kNone = 0xFFFF;
constexpr int64_t kRowBytes = kMaxBlock + 16;
constexpr int64_t kSmemBytes = kRowBytes + 2 * kMaxBlock + 2 * (int64_t(1) << kHashBits);

__device__ __forceinline__ uint32_t load32(const uint8_t* row, int64_t p) {
  return uint32_t(row[p]) | (uint32_t(row[p + 1]) << 8) | (uint32_t(row[p + 2]) << 16) |
         (uint32_t(row[p + 3]) << 24);
}

// Count of equal leading bytes of two little-endian words, from their xor.
__device__ __forceinline__ int equal_bytes(uint32_t x) {
  return (x & 0xFFu) ? 0 : (x & 0xFFFFu) ? 1 : (x & 0xFFFFFFu) ? 2 : x ? 3 : 4;
}

// The take distance of position p (0: no take) from its two most recent
// earlier positions with the same key, q1 > q2 (-1: none).
__device__ __forceinline__ uint16_t choose(const uint8_t* row, int64_t p, int64_t q1, int64_t q2,
                                           int min_profit) {
  const uint32_t w = load32(row, p + 4);
  int m1 = 0, m2 = 0, p1 = -1, p2 = -1;
  if (q1 >= 0) {
    m1 = 4 + equal_bytes(w ^ load32(row, q1 + 4));
    p1 = m1 - (p - q1 < 2048 ? 2 : 3);
  }
  if (q2 >= 0) {
    m2 = 4 + equal_bytes(w ^ load32(row, q2 + 4));
    p2 = m2 - (p - q2 < 2048 ? 2 : 3);
  }
  const bool use2 = p2 >= p1 && q2 >= 0;
  const int m = use2 ? m2 : m1;
  const int best = p1 > p2 ? p1 : p2;
  if (best < min_profit || m < 4) return 0;
  return uint16_t(p - (use2 ? q2 : q1));
}

// The first position >= q holding a take, or nkeys. Warp-uniform.
__device__ __forceinline__ int64_t next_take(const uint16_t* take, int64_t q, int64_t nkeys,
                                             int lane) {
  for (int64_t base = q; base < nkeys; base += kWarp) {
    const int64_t p = base + lane;
    const uint32_t hit = __ballot_sync(kFull, p < nkeys && take[p] != 0);
    if (hit) return base + __ffs(hit) - 1;
  }
  return nkeys;
}

// Length of the common prefix of row[a:] and row[b:], cut at limit.
// Warp-uniform.
__device__ __forceinline__ int64_t match_length(const uint8_t* row, int64_t a, int64_t b,
                                                int64_t limit, int lane) {
  for (int64_t base = 0; base < limit; base += kWarp) {
    const int64_t k = base + lane;
    const uint32_t stop = __ballot_sync(kFull, k >= limit || row[a + k] != row[b + k]);
    if (stop) return base + __ffs(stop) - 1;
  }
  return limit;
}

// Literal of row[start, start + n) at output position op; lane 0 writes the
// tag, the warp the body. Returns the new output position.
__device__ __forceinline__ int64_t emit_literal(uint8_t* dst, const uint8_t* row, int64_t start,
                                                int64_t n, int64_t op, int lane) {
  if (n <= 0) return op;
  const int64_t nm1 = n - 1;
  const int64_t hl = nm1 < 60 ? 1 : nm1 < 256 ? 2 : 3;
  if (lane == 0) {
    if (nm1 < 60) {
      dst[op] = uint8_t(nm1 << 2);
    } else if (nm1 < 256) {
      dst[op] = 60 << 2;
      dst[op + 1] = uint8_t(nm1);
    } else {
      dst[op] = 61 << 2;
      dst[op + 1] = uint8_t(nm1 & 0xFF);
      dst[op + 2] = uint8_t(nm1 >> 8);
    }
  }
  for (int64_t j = lane; j < n; j += kWarp) dst[op + hl + j] = row[start + j];
  return op + hl + n;
}

__device__ __forceinline__ int64_t emit_copy2(uint8_t* dst, int64_t d, int64_t m, int64_t op,
                                              int lane) {
  if (lane == 0) {
    dst[op] = uint8_t(0x02 | ((m - 1) << 2));
    dst[op + 1] = uint8_t(d & 0xFF);
    dst[op + 2] = uint8_t(d >> 8);
  }
  return op + 3;
}

// Copy of m bytes at distance d: COPY_2 chunks of 64 while 68 or more
// remain, one of 60 above 64, then COPY_1 or COPY_2.
__device__ __forceinline__ int64_t emit_copy(uint8_t* dst, int64_t d, int64_t m, int64_t op,
                                             int lane) {
  for (; m >= 68; m -= 64) op = emit_copy2(dst, d, 64, op, lane);
  if (m > 64) {
    op = emit_copy2(dst, d, 60, op, lane);
    m -= 60;
  }
  if (m < 12 && d < 2048) {
    if (lane == 0) {
      dst[op] = uint8_t(0x01 | ((m - 4) << 2) | ((d >> 8) << 5));
      dst[op + 1] = uint8_t(d & 0xFF);
    }
    return op + 2;
  }
  return emit_copy2(dst, d, m, op, lane);
}

__global__ void __launch_bounds__(kThreads)
encode_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ blens,
                     int64_t row_w, int64_t out_w, int min_profit, uint8_t* __restrict__ out,
                     int32_t* __restrict__ olens) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* row = smem;
  uint16_t* link = reinterpret_cast<uint16_t*>(smem + kRowBytes);
  uint16_t* head = link + kMaxBlock;
  const int64_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const uint8_t* src = blocks + r * row_w;
  uint8_t* dst = out + r * out_w;

  // The wrapper does not read the lengths (that would wait for the
  // stream): a row whose blen does not fit encodes nothing and comes back
  // with olens = -1, all zero.
  int64_t blen = blens[r];
  const bool fits = blen >= 0 && blen <= row_w - kEncPad;
  if (!fits) blen = 0;
  const int64_t nkeys = blen >= 4 ? blen - 3 : 0;

  // 1. Stage the row; the bytes past blen read as zero.
  int64_t head8 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const int64_t n8 = blen >> 3;
    const uint2* s8 = reinterpret_cast<const uint2*>(src);
    uint2* d8 = reinterpret_cast<uint2*>(row);
    for (int64_t i = tid; i < n8; i += kThreads) d8[i] = s8[i];
    head8 = n8 << 3;
  }
  for (int64_t i = head8 + tid; i < blen; i += kThreads) row[i] = src[i];
  for (int64_t i = blen + tid; i < blen + 16; i += kThreads) row[i] = 0;
  for (int64_t i = tid; i < (int64_t(1) << kHashBits); i += kThreads) head[i] = kNone;
  __syncthreads();

  // 2. Hash chain, in position order, by warp 0: 32 positions a step; a
  // lane links to the highest lower lane with its hash, or to the head.
  // Keys of 0xFFFFFFFF (and positions past blen - 4) stay out of it.
  if (tid < kWarp) {
    for (int64_t base = 0; base < nkeys; base += kWarp) {
      const int64_t p = base + lane;
      const uint32_t key = p < nkeys ? load32(row, p) : kSentinel;
      const bool valid = key != kSentinel;
      const uint32_t h = valid ? (key * kHashMul) >> (32 - kHashBits) : kSentinel;
      const uint32_t peers = __match_any_sync(kFull, h);
      const uint32_t below = peers & ((1u << lane) - 1u);
      const uint32_t above = lane == kWarp - 1 ? 0u : peers >> (lane + 1);
      const uint16_t prev = below ? uint16_t(base + 31 - __clz(below)) : head[h & ((1u << kHashBits) - 1u)];
      __syncwarp();
      if (valid) {
        link[p] = prev;
        if (!above) head[h] = uint16_t(p);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. Candidates, all threads, one position each, chunks from the top
  // down: a chain only reaches lower positions, so once a chunk's chains
  // are walked its entries can hold take distances instead.
  for (int64_t c = (nkeys + kThreads - 1) / kThreads - 1; c >= 0; --c) {
    const int64_t p = c * kThreads + tid;
    uint16_t take = 0;
    const uint32_t key = p < nkeys ? load32(row, p) : kSentinel;
    if (key != kSentinel) {
      int64_t q1 = -1, q2 = -1;
      for (uint32_t q = link[p]; q != kNone; q = link[q]) {
        if (load32(row, q) != key) continue;
        if (q1 < 0) {
          q1 = q;
        } else {
          q2 = q;
          break;
        }
      }
      take = choose(row, p, q1, q2, min_profit);
    }
    __syncthreads();
    if (p < nkeys) link[p] = take;
  }
  __syncthreads();

  // 4. The walk and emission, by warp 0.
  int32_t* row_op = reinterpret_cast<int32_t*>(head);
  if (tid < kWarp) {
    int64_t anchor = 0, op = 0;
    for (int64_t ip = next_take(link, 0, nkeys, lane); ip < nkeys;
         ip = next_take(link, anchor, nkeys, lane)) {
      const int64_t d = link[ip];
      const int64_t m = match_length(row, ip, ip - d, blen - ip, lane);
      op = emit_literal(dst, row, anchor, ip - anchor, op, lane);
      op = emit_copy(dst, d, m, op, lane);
      anchor = ip + m;
    }
    op = emit_literal(dst, row, anchor, blen - anchor, op, lane);
    if (lane == 0) {
      olens[r] = fits ? int32_t(op) : -1;
      *row_op = int32_t(op);
    }
  }
  __syncthreads();

  // 5. Zero the rest of the output row.
  for (int64_t i = *row_op + tid; i < out_w; i += kThreads) dst[i] = 0;
}

}  // namespace

extern "C" {

// Launch the encoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_encode_blocks(const void* blocks, const void* blens, int64_t rows, int64_t row_w,
                              int64_t out_w, int min_profit, void* out, void* olens,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (row_w < kEncPad || row_w - kEncPad > kMaxBlock || out_w < kBlockMaxOut) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      encode_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return err;
  encode_blocks_kernel<<<dim3(unsigned(rows)), kThreads, size_t(kSmemBytes),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(blens), row_w, out_w,
      min_profit, static_cast<uint8_t*>(out), static_cast<int32_t*>(olens));
  return cudaGetLastError();
}

}  // extern "C"
