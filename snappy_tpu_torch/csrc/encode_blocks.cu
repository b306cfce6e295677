// Snappy block encoder for Hopper (sm_90a): one thread block per block of
// up to 64 KiB, in one of two variants sized by the batch's row width.
//
// Replaces snappy_tpu/ops/pallas_encode.py::_encode_kernel (with its XLA
// prepass candidate_cmds), run with contest=False. It keeps that kernel's
// output byte for byte and none of its TPU layout:
//   in:  blocks u8[B, W] (row b holds blens[b] bytes, W >= blen + 8,
//        W - 8 <= 65536), blens i32[B], min_profit
//   out: out u8[B, out_w] (the headerless tag stream, zero past olens),
//        olens i32[B].
// Its ragged entry (snappy_cuda_encode_fragments) reads each row in place
// from one buffer instead: row r is the blens[r] bytes at starts[r], staged
// into shared memory as a fixed row is, so the same bytes give the same
// stream; a fragment that does not lie in the buffer is refused as a row
// whose blen does not fit.
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
// takes, several thousand for a text block; and the shared memory a block
// needs leaves one block (64 KiB rows) or two (32 KiB rows) an SM, so a
// block's latency is the kernel's time divided by its waves. One thread on
// a chain runs every instruction of it alone, each after the one it waits
// for, so the design keeps as few instructions on the chain as the TPU
// kernel keeps (take_step, pallas_encode.py:514-597):
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
// Shared memory of a variant for blocks of up to kMaxBlock = 2^kBlockBits
// bytes (232,432 bytes at 64 KiB, of the 232,448 a block may have;
// 115,696 at 32 KiB, so that two blocks and their 1 KiB reserves fit the
// SM's 233,472):
//   row    u8[kMaxBlock + 16]  the block, zero from blen on
//   link   u16[kMaxBlock]      first the hash chain (the previous position
//                              with the same hash of kBlockBits - 2 bits),
//                              then each position's take distance (0: no
//                              take)
//   head   u16[kMaxBlock / 4]  the newest position of each hash, while the
//                              chain is built; then the 4-bit take fields,
//                              8 to a 32-bit word, the first position's in
//                              the top bits
//   rec    u32x2[kChunk]       the records of one chunk: position | length
//                              << 16, from the chase; output position, from
//                              the scan
//   ctl    i32[8]              the chunk's record count, its first
//                              literal's start, the end of the chase, the
//                              tail literal's start, the next record's
//                              output position
// Why these fields and not a 1-bit take map beside recomputed lengths: the
// fields fill exactly the heads' region, and they keep the short length on
// the chased position, so the chain is one load a take instead of three
// (map, distance, row compare). A device-memory record buffer would cost a
// round trip to L2 a record in the drains; the records fit what the SM has
// left, at the price of a drain every kChunk takes (376 at 64 KiB, 120 at
// 32 KiB). Candidates are exact: a chain is walked comparing full keys, so
// the hash's width never changes the output, and a chain of colliding keys
// makes a position slow, never wrong.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads a block, for every variant; 0 keeps each variant's own.
#ifndef SNAPPY_ENC_THREADS
#define SNAPPY_ENC_THREADS 0
#endif

constexpr int kWarp = 32;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int64_t kEncPad = 8;
// The widest block the encoder takes: copy offsets are 16 bits.
constexpr int kWidestBits = 16;
constexpr int64_t kBlockMaxOut = 32 + (int64_t(1) << kWidestBits) + (int64_t(1) << kWidestBits) / 6;
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
// Shared memory an SM has, and what the card reserves a block of it.
constexpr int64_t kSmemPerSm = 233472;
constexpr int64_t kSmemReserved = 1024;
constexpr int64_t kSmemPerBlockMax = 232448;

// Each variant's knobs: threads a block, blocks an SM must hold (the
// launch bounds), records of one chunk of the chase.
template <int kBlockBits>
struct Knobs;
template <>
struct Knobs<16> {
  static constexpr int kThreads = 1024, kBlocksPerSm = 1, kChunk = 376;
};
template <>
struct Knobs<15> {
  static constexpr int kThreads = 1024, kBlocksPerSm = 2, kChunk = 120;
};

// The layout of the variant for blocks of up to 2^kBlockBits bytes.
template <int kBlockBits>
struct Shape {
  static constexpr int kThreads = SNAPPY_ENC_THREADS ? SNAPPY_ENC_THREADS : Knobs<kBlockBits>::kThreads;
  static constexpr int kWarps = kThreads / kWarp;
  static constexpr int kBlocksPerSm = Knobs<kBlockBits>::kBlocksPerSm;
  static constexpr int kChunk = Knobs<kBlockBits>::kChunk;
  static constexpr int64_t kMaxBlock = int64_t(1) << kBlockBits;
  // Two bits fewer than a position, so that the heads' region holds one
  // 4-bit field a position.
  static constexpr int kHashBits = kBlockBits - 2;
  static constexpr int64_t kRowBytes = kMaxBlock + 16;
  static constexpr int64_t kLinkBytes = 2 * kMaxBlock;
  static constexpr int64_t kHeadBytes = 2 * (int64_t(1) << kHashBits);
  static constexpr int64_t kRecBytes = 8 * int64_t(kChunk);
  static constexpr int64_t kCtlBytes = 4 * 8;
  static constexpr int64_t kSmemBytes = kRowBytes + kLinkBytes + kHeadBytes + kRecBytes + kCtlBytes;
  static_assert(kBlockBits <= kWidestBits, "copy offsets are 16 bits");
  static_assert(2 * kHeadBytes == kMaxBlock, "the heads' region holds one 4-bit field a position");
  static_assert(kSmemBytes <= kSmemPerBlockMax, "more shared memory than a Hopper block may have");
  static_assert(kBlocksPerSm * (kSmemBytes + kSmemReserved) <= kSmemPerSm, "the SM does not hold the blocks");
  static_assert(kThreads % kWarp == 0 && kWarps >= 1, "whole warps");
};

// The narrowest variant that holds rows of row_w bytes (row_w - kEncPad
// bytes of block): 32 KiB blocks or 64 KiB.
inline int block_bits_for(int64_t row_w) { return row_w - kEncPad <= (int64_t(1) << 15) ? 15 : 16; }

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

// One row of the batch by the whole block: the body of both kernels below.
// Row r is a fixed row of `blocks` where `starts` is null, else the
// fragment at starts[r] of a buffer of data_len bytes.
template <int kBlockBits>
__device__ __forceinline__ void encode_row(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ blens,
                                           int64_t row_w, int64_t out_w, int min_profit, uint8_t* __restrict__ out,
                                           int32_t* __restrict__ olens, const int64_t* __restrict__ starts,
                                           int64_t data_len) {
  using S = Shape<kBlockBits>;
  constexpr int kThreads = S::kThreads, kWarps = S::kWarps, kHashBits = S::kHashBits, kChunk = S::kChunk;
  constexpr int64_t kMaxBlock = S::kMaxBlock, kRowBytes = S::kRowBytes, kLinkBytes = S::kLinkBytes;
  constexpr int64_t kHeadBytes = S::kHeadBytes;
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
  // A fixed row lies at r * row_w; a fragment (starts given) at its start
  // in a buffer of data_len bytes, where it is read in place.
  const int64_t from = starts == nullptr ? r * row_w : starts[r];
  const uint8_t* src = blocks + from;
  uint8_t* dst = out + r * out_w;

  // The wrapper does not read the lengths (that would wait for the
  // stream): a row whose blen does not fit, or a fragment that does not
  // lie in its buffer, encodes nothing and comes back with olens = -1, all
  // zero.
  int64_t blen = blens[r];
  const bool fits = blen >= 0 && blen <= row_w - kEncPad &&
                    (starts == nullptr || (from >= 0 && from <= data_len - blen));
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

// A variant that must hold two blocks an SM bounds its registers to half
// the SM's (32 a thread at 1,024 threads). One block an SM states no
// minimum (0): the compiler's own budget is 32 registers, where a minimum
// of 1 lets it take 56 and runs the 64 KiB rows 0.5% slower.
#define SNAPPY_ENC_BOUNDS                          \
  __launch_bounds__(Shape<kBlockBits>::kThreads, \
                    Shape<kBlockBits>::kBlocksPerSm > 1 ? Shape<kBlockBits>::kBlocksPerSm : 0)

// Fixed rows: row r at r * row_w of `blocks`.
template <int kBlockBits>
__global__ void SNAPPY_ENC_BOUNDS encode_blocks_kernel(const uint8_t* __restrict__ blocks,
                                                       const int32_t* __restrict__ blens, int64_t row_w,
                                                       int64_t out_w, int min_profit, uint8_t* __restrict__ out,
                                                       int32_t* __restrict__ olens) {
  encode_row<kBlockBits>(blocks, blens, row_w, out_w, min_profit, out, olens, nullptr, 0);
}

// Fragments read in place: row r at starts[r] of `data` (data_len bytes).
template <int kBlockBits>
__global__ void SNAPPY_ENC_BOUNDS encode_blocks_kernel(const uint8_t* __restrict__ data,
                                                       const int32_t* __restrict__ blens, int64_t row_w,
                                                       int64_t out_w, int min_profit, uint8_t* __restrict__ out,
                                                       int32_t* __restrict__ olens, const int64_t* __restrict__ starts,
                                                       int64_t data_len) {
  encode_row<kBlockBits>(data, blens, row_w, out_w, min_profit, out, olens, starts, data_len);
}

}  // namespace

extern "C" {

using KernelFn = void (*)(const uint8_t*, const int32_t*, int64_t, int64_t, int, uint8_t*, int32_t*);
using FragmentFn = void (*)(const uint8_t*, const int32_t*, int64_t, int64_t, int, uint8_t*, int32_t*,
                            const int64_t*, int64_t);

// The variant for rows of row_w bytes: its kernels (fixed rows and
// fragments), the shared memory a block takes and its threads;
// cudaErrorInvalidValue for a width the encoder does not take. A kernel's
// attributes (its shared memory, the carveout that fits its blocks an SM)
// are set once a device, when it is first picked.
static cudaError_t pick(int64_t row_w, bool fragments, KernelFn* kernel, FragmentFn* fragment_kernel,
                        int64_t* smem, int* threads) {
  static unsigned long long ready[2][2];  // a bit a device, by kind, for 32 KiB and 64 KiB
  if (row_w < kEncPad || row_w - kEncPad > (int64_t(1) << kWidestBits)) return cudaErrorInvalidValue;
  const bool narrow = block_bits_for(row_w) == 15;
  if (narrow) {
    *kernel = encode_blocks_kernel<15>;
    *fragment_kernel = encode_blocks_kernel<15>;
  } else {
    *kernel = encode_blocks_kernel<16>;
    *fragment_kernel = encode_blocks_kernel<16>;
  }
  *smem = narrow ? Shape<15>::kSmemBytes : Shape<16>::kSmemBytes;
  *threads = narrow ? Shape<15>::kThreads : Shape<16>::kThreads;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (__atomic_load_n(&ready[fragments][narrow], __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  const int carveout = int(cudaSharedmemCarveoutMaxShared);
  if (fragments) {
    err = cudaFuncSetAttribute(*fragment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(*fragment_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    }
  } else {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    }
  }
  if (err == cudaSuccess) __atomic_fetch_or(&ready[fragments][narrow], bit, __ATOMIC_ACQ_REL);
  return err;
}

// Launch the encoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_encode_blocks(const void* blocks, const void* blens, int64_t rows, int64_t row_w,
                              int64_t out_w, int min_profit, void* out, void* olens,
                              void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (out_w < kBlockMaxOut) return cudaErrorInvalidValue;
  KernelFn kernel;
  FragmentFn unused;
  int64_t smem;
  int threads;
  cudaError_t err = pick(row_w, false, &kernel, &unused, &smem, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(rows)), threads, size_t(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(blens), row_w, out_w,
      min_profit, static_cast<uint8_t*>(out), static_cast<int32_t*>(olens));
  return cudaGetLastError();
}

// Launch the encoder over `rows` fragments of the buffer `data` (data_len
// bytes) on `stream`: fragment r is the flens[r] bytes at fstarts[r], read
// in place, of at most max_block bytes, which picks the variant as a row of
// max_block + 8 bytes does. Returns the cudaError_t of the launch; does not
// synchronise.
int snappy_cuda_encode_fragments(const void* data, int64_t data_len, const void* fstarts, const void* flens,
                                 int64_t rows, int64_t max_block, int64_t out_w, int min_profit, void* out,
                                 void* olens, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (out_w < kBlockMaxOut) return cudaErrorInvalidValue;
  KernelFn unused;
  FragmentFn kernel;
  int64_t smem;
  int threads;
  const int64_t row_w = max_block + kEncPad;
  cudaError_t err = pick(row_w, true, &unused, &kernel, &smem, &threads);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(rows)), threads, size_t(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(flens), row_w, out_w, min_profit,
      static_cast<uint8_t*>(out), static_cast<int32_t*>(olens), static_cast<const int64_t*>(fstarts), data_len);
  return cudaGetLastError();
}

// The shared memory a block of the variant for rows of row_w bytes takes,
// and how many of its blocks one SM of the current device holds at once.
int snappy_cuda_encode_blocks_occupancy(int64_t row_w, int* smem_bytes, int* blocks_per_sm) {
  KernelFn kernel;
  FragmentFn unused;
  int64_t smem;
  int threads;
  cudaError_t err = pick(row_w, false, &kernel, &unused, &smem, &threads);
  if (err != cudaSuccess) return err;
  *smem_bytes = int(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, size_t(smem));
}

}  // extern "C"
