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
// ties to the farther one) where that score reaches min_profit; the parse
// emits a literal and the longest copy at each take and resumes at the
// first take at or after the copy's end.
//
// What bounds it on the card: the parse. Each take depends on where the
// previous copy ended, so a block is one dependent chain through its
// takes, several thousand for a text block; and the 224 KiB of shared
// memory a block needs leaves one block per SM, so a block's latency is
// the kernel's time divided by its waves. One thread on a chain runs
// every instruction of it alone, each after the one it waits for, so the
// design keeps as few instructions on the chain as the TPU kernel keeps
// (take_step, pallas_encode.py:514-597):
//   - the candidate pass (all threads) leaves beside each position a 4-bit
//     take field: 0 for no take, else a take bit and the match length 4..8
//     (exact below 8, as candidate_cmds keeps it);
//   - one thread chases the takes in 32-bit arithmetic (64-bit integer ops
//     take two instructions each on this card), with no bound check in its
//     search (a field marks position nkeys): one shared load finds the
//     next take among 8 positions (32 a 16-byte load across a literal) and
//     gives its length, so a take whose match is below 8 bytes costs one
//     dependent load and a dozen integer ops, with no warp vote or shuffle;
//     only a length of 8 reads the distance and extends the match with
//     word compares, 8 bytes a step. It records each take as (position,
//     length) and nothing more;
//   - every kChunk records, the drain: warp 0 gives each record its output
//     position by a warp scan of the records' tag and body bytes, then all
//     warps write them: warp w takes records k = w (mod warps), lane 0
//     writes the tags, the lanes the literal's bytes. The tail literal is
//     written by the whole block.
// The hash chain (one warp) and the candidate pass keep their design; they
// are the next redesign.
//
// Shared memory, 232,432 bytes of the 232,448 a block may have:
//   row    u8[65552]   the block, zero from blen on
//   link   u16[65536]  first the hash chain (the previous position with the
//                      same 14-bit hash), then each position's take
//                      distance (0: no take)
//   head   u16[16384]  the newest position of each hash, while the chain is
//                      built; then the 4-bit take fields, 8 to a 32-bit
//                      word, the first position's in the top bits
//   rec    u32x2[376]  the records of one chunk: position | length << 16,
//                      from the chase; output position, from the scan
//   ctl    i32[8]      the chunk's record count, its first literal's start,
//                      the end of the chase, the tail literal's start, the
//                      next record's output position
// Why these fields and not a 1-bit take map beside recomputed lengths: the
// fields fill exactly the 32 KiB the chain's heads leave, and they keep
// the short length on the chased position, so the chain is one load a take
// instead of three (map, distance, row compare). A device-memory record
// buffer would cost a round trip to L2 a record in the drains; the records
// fit the 3 KiB left over, at the price of a drain every 376 takes.
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
constexpr int kWarps = kThreads / kWarp;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int64_t kEncPad = 8;
constexpr int64_t kMaxBlock = 1 << 16;
constexpr int64_t kBlockMaxOut = 32 + kMaxBlock + kMaxBlock / 6;
constexpr int kHashBits = 14;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint16_t kNone = 0xFFFF;
// Match lengths from the candidate pass are exact below this.
constexpr uint32_t kMCap = 8;
// Offsets below this take a 2-byte copy tag where the length allows.
constexpr uint32_t kCopy1MaxDistance = 2048;
// A take field: bit 3 set for a take, the low three bits its match length
// less 4; 0 for no take. kTakeBits holds bit 3 of each field of a word.
constexpr uint32_t kTake = 8;
constexpr uint32_t kTakeBits = 0x88888888u;
// Records of one chunk of the chase.
constexpr int kChunk = 376;
constexpr int64_t kRowBytes = kMaxBlock + 16;
constexpr int64_t kLinkBytes = 2 * kMaxBlock;
constexpr int64_t kHeadBytes = 2 * (int64_t(1) << kHashBits);
constexpr int64_t kRecBytes = 8 * int64_t(kChunk);
constexpr int64_t kCtlBytes = 4 * 8;
constexpr int64_t kSmemBytes = kRowBytes + kLinkBytes + kHeadBytes + kRecBytes + kCtlBytes;
static_assert(2 * kHeadBytes == kMaxBlock, "the heads' region holds one 4-bit field a position");
static_assert(kSmemBytes <= 232448, "more shared memory than a Hopper block may have");
static_assert(kThreads % kWarp == 0 && kWarps >= 1, "whole warps");

__device__ __forceinline__ uint32_t load32(const uint8_t* row, int64_t p) {
  return uint32_t(row[p]) | (uint32_t(row[p + 1]) << 8) | (uint32_t(row[p + 2]) << 16) |
         (uint32_t(row[p + 3]) << 24);
}

// Count of equal leading bytes of two little-endian words, from their xor.
__device__ __forceinline__ int equal_bytes(uint32_t x) {
  return (x & 0xFFu) ? 0 : (x & 0xFFFFu) ? 1 : (x & 0xFFFFFFu) ? 2 : x ? 3 : 4;
}

// The take distance of position p (0: no take) from its two most recent
// earlier positions with the same key, q1 > q2 (-1: none); m is the chosen
// candidate's match length, 4..8, exact below 8.
__device__ __forceinline__ uint16_t choose(const uint8_t* row, int64_t p, int64_t q1, int64_t q2,
                                           int min_profit, int& m) {
  const uint32_t w = load32(row, p + 4);
  int m1 = 0, m2 = 0, p1 = -1, p2 = -1;
  if (q1 >= 0) {
    m1 = 4 + equal_bytes(w ^ load32(row, q1 + 4));
    p1 = m1 - (p - q1 < int64_t(kCopy1MaxDistance) ? 2 : 3);
  }
  if (q2 >= 0) {
    m2 = 4 + equal_bytes(w ^ load32(row, q2 + 4));
    p2 = m2 - (p - q2 < int64_t(kCopy1MaxDistance) ? 2 : 3);
  }
  const bool use2 = p2 >= p1 && q2 >= 0;
  m = use2 ? m2 : m1;
  const int best = p1 > p2 ? p1 : p2;
  if (best < min_profit || m < 4) return 0;
  return uint16_t(p - (use2 ? q2 : q1));
}

// The first position >= q with a take and its match length less 4, by one
// thread: the word of q, then the rest of its group of four words, then
// whole groups, 32 positions a 16-byte load. The search needs no bound: a
// field marks position nkeys, and q <= nkeys. Position 8i + k is field k of
// word i from the top, so the first take is the word's leading set bit.
__device__ __forceinline__ uint32_t next_take(const uint32_t* field, uint32_t q, uint32_t& m4) {
  uint32_t i = q >> 3;
  uint32_t w = field[i] & (kFull >> ((q & 7) * 4));
  if (__builtin_expect(w == 0, 0)) {
    do {
      if (++i & 3) {
        w = field[i];
      } else {
        const uint4 g = reinterpret_cast<const uint4*>(field)[i >> 2];
        w = g.x | g.y | g.z | g.w;
        if (w != 0) {
          i += g.x ? 0 : g.y ? 1 : g.z ? 2 : 3;
          w = g.x ? g.x : g.y ? g.y : g.z ? g.z : g.w;
        } else {
          i += 3;
        }
      }
    } while (w == 0);
  }
  const uint32_t c = uint32_t(__clz(int(w & kTakeBits)));  // 4k for field k
  m4 = (w >> (28 - c)) & 7u;
  return 8 * i + (c >> 2);
}

// The 8 bytes row[p, p + 8) as two little-endian words, from three aligned
// word loads.
__device__ __forceinline__ void load64(const uint8_t* row, uint32_t p, uint32_t& lo, uint32_t& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (p >> 2);
  const uint32_t s = (p & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  lo = __funnelshift_r(w0, w1, s);
  hi = __funnelshift_r(w1, w2, s);
}

// Equal leading bytes of two little-endian words that differ, from their
// xor.
__device__ __forceinline__ uint32_t first_diff(uint32_t x) { return uint32_t(__ffs(int(x)) - 1) >> 3; }

// Length of the common prefix of row[a:] and row[b:], b < a, given that
// the first kMCap bytes agree, cut at limit > kMCap: 8 bytes a step. The
// row reads as zero past blen, and limit keeps the length inside it.
__device__ __forceinline__ uint32_t extend(const uint8_t* row, uint32_t a, uint32_t b, uint32_t limit) {
  for (uint32_t m = kMCap; m < limit; m += 8) {
    uint32_t a0, a1, b0, b1;
    load64(row, a + m, a0, a1);
    load64(row, b + m, b0, b1);
    const uint32_t x0 = a0 ^ b0, x1 = a1 ^ b1;
    if (x0 | x1) {
      const uint32_t e = m + (x0 ? first_diff(x0) : 4 + first_diff(x1));
      return e < limit ? e : limit;
    }
  }
  return limit;
}

// Tag and body bytes of a literal of n bytes (none for n = 0).
__device__ __forceinline__ uint32_t literal_bytes(uint32_t n) {
  return n == 0 ? 0 : n + (n - 1 < 60 ? 1 : n - 1 < 256 ? 2 : 3);
}

// Tag bytes of a copy of m bytes: COPY_2 chunks of 64 while 68 or more
// remain, one of 60 above 64, then COPY_1 (near and below 12) or COPY_2.
__device__ __forceinline__ uint32_t copy_bytes(uint32_t m, bool near) {
  uint32_t n = 0;
  if (m >= 68) {
    const uint32_t n64 = ((m - 68) >> 6) + 1;
    n = 3 * n64;
    m -= 64 * n64;
  }
  if (m > 64) {
    n += 3;
    m -= 60;
  }
  return n + (m < 12 && near ? 2 : 3);
}

// Literal of row[start, start + n) at output position op, written by
// `parts` threads of which this is `part`: part 0 writes the tag, all of
// them the body. Returns the output position after it.
__device__ __forceinline__ uint32_t emit_literal(uint8_t* dst, const uint8_t* row, uint32_t start,
                                                 uint32_t n, uint32_t op, uint32_t part, uint32_t parts) {
  if (n == 0) return op;
  const uint32_t nm1 = n - 1;
  const uint32_t hl = nm1 < 60 ? 1 : nm1 < 256 ? 2 : 3;
  if (part == 0) {
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
  for (uint32_t j = part; j < n; j += parts) dst[op + hl + j] = row[start + j];
  return op + hl + n;
}

__device__ __forceinline__ void put_copy2(uint8_t* at, uint32_t d, uint32_t m) {
  at[0] = uint8_t(0x02 | ((m - 1) << 2));
  at[1] = uint8_t(d & 0xFF);
  at[2] = uint8_t(d >> 8);
}

// Copy of m bytes at distance d at output position op, by one warp, in the
// chunks copy_bytes counts: the lanes write the chunks of 64, lane 0 the
// rest.
__device__ __forceinline__ void emit_copy(uint8_t* dst, uint32_t d, uint32_t m, uint32_t op, uint32_t lane) {
  const uint32_t n64 = m >= 68 ? ((m - 68) >> 6) + 1 : 0;
  for (uint32_t j = lane; j < n64; j += kWarp) put_copy2(dst + op + 3 * j, d, 64);
  if (lane != 0) return;
  op += 3 * n64;
  m -= 64 * n64;
  if (m > 64) {
    put_copy2(dst + op, d, 60);
    op += 3;
    m -= 60;
  }
  if (m < 12 && d < kCopy1MaxDistance) {
    dst[op] = uint8_t(0x01 | ((m - 4) << 2) | ((d >> 8) << 5));
    dst[op + 1] = uint8_t(d & 0xFF);
  } else {
    put_copy2(dst + op, d, m);
  }
}

__global__ void __launch_bounds__(kThreads)
encode_blocks_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ blens,
                     int64_t row_w, int64_t out_w, int min_profit, uint8_t* __restrict__ out,
                     int32_t* __restrict__ olens) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* row = smem;
  uint16_t* link = reinterpret_cast<uint16_t*>(smem + kRowBytes);
  uint16_t* head = link + kMaxBlock;
  uint32_t* field = reinterpret_cast<uint32_t*>(head);
  uint2* rec = reinterpret_cast<uint2*>(smem + kRowBytes + kLinkBytes + kHeadBytes);
  int32_t* ctl = reinterpret_cast<int32_t*>(rec + kChunk);
  const int64_t r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
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
  // are walked its entries can hold take distances instead. The heads are
  // no longer read: their region takes the take fields, gathered 8 to a
  // 32-bit word over the lanes.
  for (int64_t c = (nkeys + kThreads - 1) / kThreads - 1; c >= 0; --c) {
    const int64_t p = c * kThreads + tid;
    uint16_t take = 0;
    int m = 0;
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
      take = choose(row, p, q1, q2, min_profit, m);
    }
    uint32_t f = take ? kTake | uint32_t(m - 4) : 0u;
    f <<= 4 * (7 - (lane & 7));
    f |= __shfl_xor_sync(kFull, f, 1);
    f |= __shfl_xor_sync(kFull, f, 2);
    f |= __shfl_xor_sync(kFull, f, 4);
    __syncthreads();
    if (p < nkeys) link[p] = take;
    if ((lane & 7) == 0) field[p >> 3] = f;
  }
  __syncthreads();

  // 4. The chase and the drains, a chunk of records at a time. Thread 0
  // holds the chase's state across chunks; positions fit 32 bits. A take
  // field at position nkeys ends its search there.
  const uint32_t len = uint32_t(blen), keys = uint32_t(nkeys);
  uint32_t anchor = 0;
  if (tid == 0) {
    const uint32_t s = (keys & 7) * 4;
    field[keys >> 3] = (s ? field[keys >> 3] & ~(kFull >> s) : 0u) | (kTake << (28 - s));
    ctl[4] = 0;
  }
  for (;;) {
    // 4a. The chase, by thread 0: no barrier, vote or shuffle on its chain,
    // and nothing off it but the record's store.
    if (tid == 0) {
      ctl[1] = int32_t(anchor);
      int n = 0;
      while (n < kChunk) {
        uint32_t m4;
        const uint32_t ip = next_take(field, anchor < keys ? anchor : keys, m4);
        if (ip >= keys) break;
        const uint32_t limit = len - ip;
        uint32_t m = m4 + 4 < limit ? m4 + 4 : limit;
        if (__builtin_expect(m4 + 4 == kMCap && limit > kMCap, 0)) m = extend(row, ip, ip - link[ip], limit);
        rec[n++].x = ip | (m << 16);
        anchor = ip + m;
      }
      ctl[0] = n;
      ctl[2] = n < kChunk;
      ctl[3] = int32_t(anchor);
    }
    __syncthreads();
    // 4b. The drain. Warp 0 gives each record its output position: its
    // literal's and copy's tag and body bytes, summed over the records
    // before it, 32 records a warp scan.
    const int n = ctl[0];
    const bool done = ctl[2] != 0;
    if (warp == 0) {
      uint32_t op = uint32_t(ctl[4]);
      for (int base = 0; base < n; base += kWarp) {
        const int k = base + lane;
        uint32_t bytes = 0;
        if (k < n) {
          const uint32_t x = rec[k].x, ip = x & 0xFFFFu, m = x >> 16;
          uint32_t start = uint32_t(ctl[1]);
          if (k > 0) {
            const uint32_t prev = rec[k - 1].x;
            start = (prev & 0xFFFFu) + (prev >> 16);
          }
          bytes = literal_bytes(ip - start) + copy_bytes(m, link[ip] < kCopy1MaxDistance);
        }
        uint32_t sum = bytes;
        for (int s = 1; s < kWarp; s <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, sum, s);
          if (lane >= s) sum += v;
        }
        if (k < n) rec[k].y = op + sum - bytes;
        op += __shfl_sync(kFull, sum, kWarp - 1);
      }
      __syncwarp();
      if (lane == 0) ctl[4] = int32_t(op);
    }
    __syncthreads();
    // Then all warps write the records: warp w takes records k = w (mod
    // warps).
    for (int k = warp; k < n; k += kWarps) {
      const uint2 rk = rec[k];
      const uint32_t ip = rk.x & 0xFFFFu, m = rk.x >> 16;
      uint32_t start = uint32_t(ctl[1]);
      if (k > 0) {
        const uint32_t prev = rec[k - 1].x;
        start = (prev & 0xFFFFu) + (prev >> 16);
      }
      const uint32_t at = emit_literal(dst, row, start, ip - start, rk.y, lane, kWarp);
      emit_copy(dst, link[ip], m, at, lane);
    }
    __syncthreads();
    if (done) break;
  }

  // 5. The tail literal, by the whole block, and the row's length.
  const uint32_t tail = uint32_t(ctl[3]);
  const uint32_t end = emit_literal(dst, row, tail, len - tail, uint32_t(ctl[4]), tid, kThreads);
  if (tid == 0) olens[r] = fits ? int32_t(end) : -1;

  // 6. Zero the rest of the output row.
  for (int64_t i = end + tid; i < out_w; i += kThreads) dst[i] = 0;
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
