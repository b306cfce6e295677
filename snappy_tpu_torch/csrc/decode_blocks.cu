// Snappy block decoder for Hopper (sm_90a): one warp per headerless tag
// stream, walked 32 tags at a time, its output through a history window in
// shared memory.
//
// Replaces snappy_tpu/ops/pallas_decode.py::_decode_kernel (and its parse_cmds
// prepass). It keeps that kernel's contract and none of its TPU layout:
//   in:  comp u8[B, C] (row b holds clens[b] bytes, C >= clen + 4),
//        clens i32[B], ulens i32[B] (<= out_size)
//   out: out u8[B, out_size], ok u8[B] (bool), total i32[B].
// Its ragged variant (the same kernel name, the same walk) takes the rows
// that K4 (segment_streams.cu) cuts from raw streams lying end to end in one
// buffer: row b reads clens[b] bytes at comp + in_starts[b] and writes
// exactly ulens[b] bytes at out + out_starts[b], neither aligned. It writes
// nothing else, so the rows' outputs may lie side by side; a row that does
// not decode is zeroed over its own ulens[b] bytes and clears its stream's
// ok flag.
// A row that decodes holds its bytes and zeros past total; a row that does
// not is all zero and its total is not specified. The rules are those of the
// plain version, ops/decode_torch.py, which this kernel matches bit for bit:
// the walk stops when fewer than 2 bytes remain; a tag or its trailer past
// clen, a copy offset of 0 or beyond the output so far, output past ulen, and
// a final length other than ulen are corrupt.
//
// What bounds it on the card: the serial per-tag latency of one warp. Each
// tag's position depends on the previous tag's length and a copy reads bytes
// that earlier tags wrote, so a stream is one dependent chain; the bytes
// moved are few (each output byte is written once; a copied byte is also read
// once from earlier output). The design keeps that chain short, in shared
// memory, and many chains on an SM:
// - the compressed row passes through a ring of kRing bytes, staged with
//   16-byte loads whenever the next tag lies past it;
// - the first batch of a ring that can take a tag charts it, all lanes at
//   once and from the walk's position on: a table of the step from every ring
//   position to the next tag (a copy's tag bytes, a short literal's bytes
//   too), and tables of the steps two and four tags on, built by doubling; a
//   position at which the batch would end (a literal with a length trailer
//   or past the ring, a tag whose 5 bytes are not all in the ring, the
//   stream's last byte) stops them;
// - the chase follows the four-tag table, one shared load a step, up to 32
//   tags, the lanes fill in the tags between from the two- and one-tag
//   tables, and single steps take the tags before a stop, lane k keeping the
//   k-th; then every lane reads its own tag, a warp scan gives each its
//   output position and a ballot the walk's checks, for all 32 at once;
// - then the moves, in order, each split over the 32 lanes: a literal's
//   bytes from the ring, a copy as out[op + j] = out[op - f + (j mod f)] (RLE
//   included, no inner chain, the remainder without a division); a literal
//   with a length trailer, or past the ring, is moved alone, in pieces;
// - the output goes through a window of the last kWindow bytes: literals
//   and copies write it, a copy whose source lies in it reads it, and each
//   half, once full, is flushed to the row with 16-byte stores; a copy from
//   farther back reads the row in device memory, flushed before it;
// - positions and lengths are 32-bit (the row bases stay 64-bit);
// - shared memory a block does not depend on the row's width, so one kernel
//   takes every row (64 KiB framed blocks, raw segments, a whole
//   unsegmentable stream), and ten blocks share an SM: 1024 blocks run in one
//   wave on 132 SMs. A block holds the window (16 KiB), the ring (1 KiB) and
//   its three tables (1 KiB each), the step by tag byte (256 B) and a batch's
//   records (512 B): 21,248 B. Ten blocks an SM, each with the 1 KiB the
//   card reserves for a block, leave a block at most 22,323 B.
// - a ragged row stages from the 16-byte chunk that holds its first byte, so
//   its ring loads stay 16 bytes wide wherever the buffer is aligned; bytes
//   the buffer does not hold past its end are staged as zeros, as a fixed
//   row's padding is.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Output history a block keeps, and compressed bytes it stages at a time
// (bytes; a build may set them).
#ifndef SNAPPY_K1_WINDOW
#define SNAPPY_K1_WINDOW 16384
#endif
#ifndef SNAPPY_K1_RING
#define SNAPPY_K1_RING 1024
#endif

namespace {

constexpr int kCompPad = 4;
constexpr int kWarp = 32;
constexpr uint32_t kWindow = SNAPPY_K1_WINDOW;
constexpr uint32_t kWindowMask = kWindow - 1;
constexpr uint32_t kHalf = kWindow / 2;
constexpr uint32_t kRing = SNAPPY_K1_RING;
// A copy reads the window when its offset is at most kNear: then no window
// slot it reads is one it writes (a copy writes at most 64 bytes). From
// farther back it reads the row, where every byte before op - kHalf is
// flushed: with kHalf >= 128 that covers its source.
constexpr uint32_t kNear = kWindow - 64;
static_assert((kWindow & kWindowMask) == 0 && kHalf >= 128, "the window is a power of two, 256 bytes or more");
static_assert(kRing % 16 == 0 && kRing >= 64, "the ring holds whole 16-byte chunks, 64 bytes or more");
constexpr uint32_t kStop = 0xFF;  // a table entry no step crosses (a step is at most 4 x 61 bytes)

// Tag-decode LUT entry of tag byte c, computed rather than loaded (all lanes
// take the same branch): bits 0..7 length, 8..10 copy offset high bits
// pre-shifted, 11..13 number of trailer bytes. Same table as
// snappy_tpu_torch/core/constants.py::CHAR_TABLE.
__device__ __forceinline__ uint32_t tag_entry(uint32_t c) {
  const uint32_t hi6 = c >> 2, type = c & 3u;
  const bool long_lit = type == 0 && hi6 >= 60;
  const uint32_t len = type == 1 ? 4 + (hi6 & 7u) : (long_lit ? 1u : hi6 + 1);
  const uint32_t off = type == 1 ? ((c >> 5) & 7u) << 8 : 0u;
  const uint32_t taglen = type == 0 ? (long_lit ? hi6 - 59 : 0u) : (type == 3 ? 4u : type);
  return len | off | (taglen << 11);
}

__device__ __forceinline__ uint32_t lesser(uint32_t a, uint32_t b) { return a < b ? a : b; }

// j mod f for j < 64 and 1 <= f <= 64, without an integer division:
// (j + 1/2) / f lies at least 1/(2f) >= 1/128 from an integer, and the fast
// float division errs by 2 ulp (< 2^-16 there), so the quotient is exact.
__device__ __forceinline__ uint32_t mod_small(uint32_t j, uint32_t f) {
  const uint32_t q = __float2uint_rz(__fdividef(float(j) + 0.5f, float(f)));
  return j - q * f;
}

// The ring := comp bytes [base, end) of the row: from `at` rounded down to 16,
// kRing of them or up to in_end, those at or past `have` (outside the buffer)
// as zeros. 16-byte loads where the row allows them. All lanes call it.
__device__ __forceinline__ void stage(uint8_t* ring, const uint8_t* __restrict__ src, uint32_t at,
                                      uint32_t in_end, bool wide, int lane, uint32_t& base, uint32_t& end,
                                      uint32_t have) {
  __syncwarp();  // lanes may still read what the ring held
  base = at & ~15u;
  end = lesser(base + kRing, in_end);
  const uint32_t real = lesser(end, have);
  uint32_t i = lane;
  if (wide) {
    const uint32_t n16 = (real - base) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (uint32_t k = lane; k < n16; k += kWarp) r4[k] = s4[k];
    i = (n16 << 4) + lane;
  }
  for (; i < real - base; i += kWarp) ring[i] = src[base + i];
  for (; i < end - base; i += kWarp) ring[i] = 0;
  __syncwarp();
}

// The step tables of the ring: one[i], the bytes from ring position i to
// the next tag; two[i] and four[i], to the tag two and four on.
struct Steps {
  uint8_t one[kRing], two[kRing], four[kRing];
};

// Each lane takes kUnroll words of 4 positions at a time, so that their
// loads overlap.
constexpr uint32_t kUnroll = 2;

// to[i] := from[i] + from[i + from[i]], or kStop, for i in the words of 4
// positions from the one that holds lo to the one that holds len - 1.
__device__ __forceinline__ void double_steps(const uint8_t* from, uint8_t* to, uint32_t lo, uint32_t len,
                                             int lane) {
  const uint32_t* f4 = reinterpret_cast<const uint32_t*>(from);
  uint32_t* t4 = reinterpret_cast<uint32_t*>(to);
  const uint32_t words = (len + 3) >> 2;
  for (uint32_t w0 = (lo >> 2) + lane; w0 < words; w0 += kUnroll * kWarp) {
    uint32_t a[kUnroll], b[kUnroll][4];
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t w = w0 + u * kWarp;
      a[u] = w < words ? f4[w] : ~0u;
    }
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (uint32_t v = 0; v < 4; ++v) {
        const uint32_t s = (a[u] >> (8 * v)) & 0xFF, j = 4 * (w0 + u * kWarp) + v + s;
        b[u][v] = s != kStop && j < len ? from[j] : kStop;
      }
    }
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t w = w0 + u * kWarp;
      uint32_t packed = 0;
#pragma unroll
      for (uint32_t v = 0; v < 4; ++v) {
        const uint32_t s = (a[u] >> (8 * v)) & 0xFF;
        packed |= (b[u][v] == kStop ? kStop : s + b[u][v]) << (8 * v);
      }
      if (w < words) t4[w] = packed;
    }
  }
}

// The tables of the ring [rbase, rend) from ring position lo on. kStop
// where the chase ends its batch at the tag: a literal with a length trailer
// or whose bytes run past the ring, a tag whose 5 bytes are not all in the
// ring, one at or past the stream's last byte; and (two, four) where a tag
// the step crosses is so. `advance` is one[] by tag byte alone. All lanes
// call it, with a tag at rbase + lo that the chase can take.
__device__ __forceinline__ void chart(Steps& st, const uint8_t* ring, const uint8_t* advance, uint32_t lo,
                                      uint32_t rbase, uint32_t rend, uint32_t clen, int lane) {
  const uint32_t len = rend - rbase, words = (len + 3) >> 2;
  // A tag at or past this ring position has fewer than 5 bytes in the ring
  // or is at or past the stream's last byte.
  const uint32_t last = lesser(clen - 1, rend - 4) - rbase;
  const uint32_t* r4 = reinterpret_cast<const uint32_t*>(ring);
  uint32_t* o4 = reinterpret_cast<uint32_t*>(st.one);
  for (uint32_t w0 = (lo >> 2) + lane; w0 < words; w0 += kUnroll * kWarp) {
    uint32_t r[kUnroll];
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t w = w0 + u * kWarp;
      r[u] = w < words ? r4[w] : 0u;
    }
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t w = w0 + u * kWarp;
      uint32_t packed = 0;
#pragma unroll
      for (uint32_t v = 0; v < 4; ++v) {
        const uint32_t i = 4 * w + v, d = advance[(r[u] >> (8 * v)) & 0xFF];
        packed |= (i < last && i + d <= len ? d : kStop) << (8 * v);
      }
      if (w < words) o4[w] = packed;
    }
  }
  __syncwarp();
  double_steps(st.one, st.two, lo, len, lane);
  __syncwarp();
  double_steps(st.two, st.four, lo, len, lane);
  __syncwarp();
}

// The tag byte at t and the 4 bytes after it (little-endian).
__device__ __forceinline__ void read_tag(const uint8_t* t, uint32_t& c, uint32_t& word) {
  c = t[0];
  word = uint32_t(t[1]) | uint32_t(t[2]) << 8 | uint32_t(t[3]) << 16 | uint32_t(t[4]) << 24;
}

// The window's bytes of output [op, op + n) := from[0, n) (in the ring).
// Each lane moves bytes lane, lane + 32, ... eight at a time, all eight read
// before any is written: window and ring share one array, so the compiler
// would not move a read above a write, and each read would wait for the one
// before it.
__device__ __forceinline__ void move_literal(uint8_t* win, const uint8_t* from, uint32_t op, uint32_t n,
                                             int lane) {
  constexpr uint32_t kUnroll = 8;
  for (uint32_t j0 = lane; j0 < n; j0 += kUnroll * kWarp) {
    uint8_t v[kUnroll];
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t j = j0 + u * kWarp;
      v[u] = j < n ? from[j] : 0;
    }
#pragma unroll
    for (uint32_t u = 0; u < kUnroll; ++u) {
      const uint32_t j = j0 + u * kWarp;
      if (j < n) win[(op + j) & kWindowMask] = v[u];
    }
  }
}

// dst[from, to) := the window's bytes of those output positions, which lie
// in one half (from is a multiple of 16); 16-byte stores where dst allows.
__device__ __forceinline__ void flush(uint8_t* dst, const uint8_t* win, uint32_t from, uint32_t to, bool wide,
                                      int lane) {
  const uint8_t* s = win + (from & kWindowMask);
  const uint32_t n = to - from;
  uint32_t i = lane;
  if (wide) {
    const uint32_t n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(dst + from);
    for (uint32_t k = lane; k < n16; k += kWarp) d4[k] = s4[k];
    i = (n16 << 4) + lane;
  }
  for (; i < n; i += kWarp) dst[from + i] = s[i];
}

// dst[from, to) := 0 (from is a multiple of 16).
__device__ __forceinline__ void zero(uint8_t* dst, int64_t from, int64_t to, bool wide, int lane) {
  int64_t i = from + lane;
  if (wide && to > from) {
    const int64_t n16 = (to - from) >> 4;
    const uint4 z = {0u, 0u, 0u, 0u};
    uint4* d4 = reinterpret_cast<uint4*>(dst + from);
    for (int64_t k = lane; k < n16; k += kWarp) d4[k] = z;
    i = from + (n16 << 4) + lane;
  }
  for (; i < to; i += kWarp) dst[i] = 0;
}

// Where the rows of a ragged launch lie.
struct Ragged {
  const int64_t* in_starts;   // row b's stream: clens[b] bytes at comp + in_starts[b]
  const int64_t* out_starts;  // its output: ulens[b] bytes at out + out_starts[b]
  const int32_t* streams;     // the stream row b belongs to
  uint8_t* stream_ok;         // a stream's flag, cleared by its rows that do not decode
  const int64_t* rows;        // rows[0]: the rows that hold segments; blocks past them exit
  int64_t comp_len, out_len;  // bytes of comp and of out
};

// One row of either variant: block blockIdx.x's. A fixed row lies at
// comp + b * row_c, its output at out + b * out_size; a ragged one where
// `rag` says (row_c and out_size are then 0).
template <bool kRagged>
__device__ __forceinline__ void decode_row(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                                           const int32_t* __restrict__ ulens, int64_t row_c, int64_t out_size,
                                           uint8_t* out, uint8_t* __restrict__ ok_out,
                                           int32_t* __restrict__ total_out, const Ragged& rag) {
  // The window, then the ring, in one array: a move reads either by index.
  __shared__ __align__(16) uint8_t smem[kWindow + kRing];
  __shared__ uint4 recs[kWarp];  // a batch's tags: output position, length | literal flag, source
  __shared__ __align__(16) Steps st;
  __shared__ uint8_t advance[256];  // the step past a tag, by its byte; kStop for a literal with a trailer
  uint8_t* const win = smem;
  uint8_t* const ring = smem + kWindow;
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x;
  if (kRagged && row >= rag.rows[0]) return;
  for (uint32_t c = lane; c < 256; c += kWarp) {
    const uint32_t entry = tag_entry(c);
    advance[c] = uint8_t(c & 3u ? 1 + (entry >> 11) : (entry >> 11) == 0 ? 1 + (entry & 0xFF) : kStop);
  }
  __syncwarp();
  const uint8_t* src = comp + row * row_c;
  uint8_t* dst = out + row * out_size;

  // The wrapper does not read the lengths (that would wait for the stream):
  // a row whose lengths do not fit decodes nothing and comes back not ok and
  // all zero, reading or writing nothing outside its own row. A ragged row
  // that does not fit its buffers writes nothing at all.
  const int64_t clen64 = clens[row], ulen64 = ulens[row];
  bool ok;
  uint32_t shift = 0;    // bytes staged before a ragged row's stream
  int64_t have = row_c;  // bytes of comp from src on
  bool aligned = (uintptr_t(row_c) & 15) == 0;
  if (kRagged) {
    const int64_t in0 = rag.in_starts[row], out0 = rag.out_starts[row];
    ok = in0 >= 0 && clen64 >= 0 && in0 <= rag.comp_len - clen64 && out0 >= 0 && ulen64 >= 0 &&
         out0 <= rag.out_len - ulen64;
    aligned = (reinterpret_cast<uintptr_t>(comp) & 15) == 0;
    shift = ok && aligned ? uint32_t(in0 & 15) : 0u;
    src = comp + (ok ? in0 - shift : 0);
    dst = out + (ok ? out0 : 0);
    have = ok ? rag.comp_len - (in0 - shift) : 0;
    out_size = ok ? ulen64 : 0;
  } else {
    ok = clen64 >= 0 && clen64 <= row_c - kCompPad && ulen64 >= 0 && ulen64 <= out_size;
  }
  const uint32_t clen = ok ? uint32_t(clen64) + shift : 0, ulen = ok ? uint32_t(ulen64) : 0;
  // 16-byte moves where the row's start (and, for the input, width) allow.
  const bool wide_in = aligned && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const bool wide_out = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  // The ring reads no further than the stream and its padding.
  const uint32_t in_end = wide_in ? (clen + kCompPad + 15) & ~15u : clen + kCompPad;
  const uint32_t in_have = uint32_t(have < int64_t(in_end) ? have : int64_t(in_end));

  uint32_t ip = shift, op = 0, flushed = 0;  // the row holds output [0, flushed)
  uint32_t rbase = 0, rend = 0;          // the ring holds comp [rbase, rend)
  uint32_t charted = ~0u;                // the ring base the step tables hold, from ip on
  // Every lane walks the same tags, so all control flow is warp-uniform.
  while (ok && ip + 1 < clen) {
    // The tag lies past the ring: stage from it.
    if (ip + 5 > rend) stage(ring, src, ip, in_end, wide_in, lane, rbase, rend, in_have);
    // The ring's tables, built at its first batch whose first tag the chase
    // can take (a ring of long literals may have none).
    if (charted != rbase) {
      const uint32_t d = advance[ring[ip - rbase]];
      if (d != kStop && ip + d <= rend) {
        chart(st, ring, advance, ip - rbase, rbase, rend, clen, lane);
        charted = rbase;
      }
    }
    // The chase: the positions of up to 32 tags that lie in the ring with
    // their bytes, the k-th kept by lane k; four at a time while the tables
    // allow, then one at a time. A literal with a length trailer, or whose
    // bytes run past the ring, ends the batch.
    uint32_t at = 0, nb = 0;
    if (charted == rbase) {
      uint32_t at4 = 0;
      for (; nb + 4 <= kWarp && ip < rend; nb += 4) {
        const uint32_t d = st.four[ip - rbase];
        if (d == kStop) break;
        if (lane == int(nb >> 2)) at4 = ip;
        ip += d;
      }
      at = __shfl_sync(0xFFFFFFFFu, at4, lane >> 2);
      if (uint32_t(lane) < nb) {
        if (lane & 2) at += st.two[at - rbase];
        if (lane & 1) at += st.one[at - rbase];
      }
      for (; nb < kWarp && ip < rend; ++nb) {
        const uint32_t d = st.one[ip - rbase];
        if (d == kStop) break;
        if (lane == int(nb)) at = ip;
        ip += d;
      }
    }
    uint32_t c = 0, word = 0;  // a tag byte and the 4 bytes after it
    if (nb == 0) {
      // A literal with a length trailer or past the ring, alone.
      read_tag(ring + (ip - rbase), c, word);
      const uint32_t entry = tag_entry(c);
      const uint32_t taglen = entry >> 11;
      const uint32_t tag_end = ip + 1 + taglen;
      if (tag_end > clen) {
        ok = false;
        break;
      }
      const uint32_t trailer = taglen ? word & (0xFFFFFFFFu >> (32 - 8 * taglen)) : 0;
      // n = len + trailer bytes (len is 1 where a trailer holds the length
      // less one), taken as n - 1 so that it cannot wrap.
      const uint32_t n_less_1 = (entry & 0xFF) - 1 + trailer;
      if (n_less_1 >= clen - tag_end || n_less_1 >= ulen - op) {
        ok = false;
        break;
      }
      uint32_t n = n_less_1 + 1, s = tag_end;
      ip = s + n;
      // The literal lies past the ring: stage from it (a literal longer
      // than the ring is staged again as it is moved).
      if (ip > rend) stage(ring, src, s, in_end, wide_in, lane, rbase, rend, in_have);
      // Its bytes go from the ring through the window, at most half a
      // window at a time.
      for (;;) {
        const uint32_t piece = lesser(lesser(n, rend - s), kHalf);
        move_literal(win, ring + (s - rbase), op, piece, lane);
        op += piece;
        s += piece;
        n -= piece;
        __syncwarp();
        if (op - flushed >= kHalf) {
          flush(dst, win, flushed, flushed + kHalf, wide_out, lane);
          flushed += kHalf;
          __syncwarp();
        }
        if (n == 0) break;
        if (s == rend) stage(ring, src, s, in_end, wide_in, lane, rbase, rend, in_have);
      }
      continue;
    }
    // Each lane reads its tag: a literal of len bytes (no trailer) at
    // tag_end, or a copy of len bytes from f back; its output position is
    // op plus the lengths of the tags before it (a warp scan).
    const bool mine = uint32_t(lane) < nb;
    if (mine) read_tag(ring + (at - rbase), c, word);
    const uint32_t entry = tag_entry(c);
    const uint32_t taglen = entry >> 11;
    const uint32_t tag_end = at + 1 + taglen;
    const uint32_t trailer = taglen ? word & (0xFFFFFFFFu >> (32 - 8 * taglen)) : 0;
    const bool lit = (c & 3u) == 0;
    const uint32_t len = mine ? entry & 0xFF : 0;
    const uint32_t f = (entry & 0x700) + trailer;
    uint32_t end = len;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, end, d);
      if (lane >= d) end += v;
    }
    const uint32_t pos = op + end - len;
    // The checks of the walk, each tag at its own position: the first tag
    // that fails sees the positions of valid tags before it.
    const bool bad = tag_end > clen || (lit ? len > clen - tag_end : f == 0 || f > pos) || len > ulen - pos;
    if (__ballot_sync(0xFFFFFFFFu, mine && bad)) {
      ok = false;
      break;
    }
    if (mine) recs[lane] = uint4{pos, len | (lit ? 0x100u : 0u), lit ? tag_end - rbase : f, 0u};
    op += __shfl_sync(0xFFFFFFFFu, end, kWarp - 1);
    __syncwarp();
    // The moves, in order, each tag's record read one move ahead. Each lane
    // moves bytes j and j + 32 of a tag: both read, then both written.
    const uint32_t j0 = lane, j1 = lane + kWarp;
    uint4 next_rec = recs[0];
    for (uint32_t k = 0; k < nb; ++k) {
      const uint4 r = next_rec;
      next_rec = recs[(k + 1) & (kWarp - 1)];
      const uint32_t o = r.x, n = r.y & 0xFF, s = r.z;
      uint32_t v0 = 0, v1 = 0;
      if ((r.y & 0x100u) || s <= kNear) {
        // From shared memory: a literal's bytes in the ring, or a near copy's
        // source in the window (overlapping, s < n: the output repeats with
        // period s).
        const bool is_lit = r.y & 0x100u;
        uint32_t i0, i1;
        if (is_lit) {
          i0 = kWindow + s + j0;
          i1 = kWindow + s + j1;
        } else if (s >= n) {
          i0 = (o - s + j0) & kWindowMask;
          i1 = (o - s + j1) & kWindowMask;
        } else {
          i0 = (o - s + mod_small(j0, s)) & kWindowMask;
          i1 = (o - s + mod_small(j1, s)) & kWindowMask;
        }
        if (j0 < n) v0 = smem[i0];
        if (j1 < n) v1 = smem[i1];
      } else {
        // A far copy: the source is in the row, flushed; s > kNear >= n,
        // so the copy does not overlap itself.
        if (j0 < n) v0 = dst[o - s + j0];
        if (j1 < n) v1 = dst[o - s + j1];
      }
      if (j0 < n) win[(o + j0) & kWindowMask] = uint8_t(v0);
      if (j1 < n) win[(o + j1) & kWindowMask] = uint8_t(v1);
      // Lanes read bytes other lanes wrote for earlier tags.
      __syncwarp();
      if (o + n - flushed >= kHalf) {
        // A full half goes to the row, where far copies read it.
        flush(dst, win, flushed, flushed + kHalf, wide_out, lane);
        flushed += kHalf;
        __syncwarp();
      }
    }
  }
  __syncwarp();
  ok = ok && op == ulen;
  // Tail: the output past the last flush and zeros to the half's end, then
  // zeros to out_size; or, for a row that does not decode, zeros throughout.
  if (ok) {
    const uint32_t half_end = uint32_t(flushed + kHalf < out_size ? flushed + kHalf : out_size);
    for (uint32_t j = op + lane; j < half_end; j += kWarp) win[j & kWindowMask] = 0;
    __syncwarp();
    flush(dst, win, flushed, half_end, wide_out, lane);
    zero(dst, int64_t(flushed) + kHalf, out_size, wide_out, lane);
  } else {
    zero(dst, 0, out_size, wide_out, lane);
  }
  if (lane == 0) {
    ok_out[row] = ok ? 1 : 0;
    if (kRagged && !ok) rag.stream_ok[rag.streams[row]] = 0;
    total_out[row] = static_cast<int32_t>(op);
  }
}

__global__ void __launch_bounds__(kWarp)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                     const int32_t* __restrict__ ulens, int64_t row_c, int64_t out_size,
                     uint8_t* out, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ total_out) {
  decode_row<false>(comp, clens, ulens, row_c, out_size, out, ok_out, total_out, Ragged{});
}

// The ragged variant: the same walk over rows that lie where `rag` says.
__global__ void __launch_bounds__(kWarp)
decode_blocks_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                     const int32_t* __restrict__ ulens, uint8_t* out, uint8_t* __restrict__ ok_out,
                     int32_t* __restrict__ total_out, const Ragged rag) {
  decode_row<true>(comp, clens, ulens, 0, 0, out, ok_out, total_out, rag);
}

using FixedKernel = void (*)(const uint8_t*, const int32_t*, const int32_t*, int64_t, int64_t, uint8_t*, uint8_t*,
                             int32_t*);
using RaggedKernel = void (*)(const uint8_t*, const int32_t*, const int32_t*, uint8_t*, uint8_t*, int32_t*,
                              Ragged);

}  // namespace

extern "C" {

// Ten blocks of ~21 KiB an SM need the largest shared-memory carveout. The
// preference belongs to the current device; it is set once on each (on
// devices past the 64th, at every call).
static cudaError_t prefer_shared() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(static_cast<FixedKernel>(decode_blocks_kernel),
                             cudaFuncAttributePreferredSharedMemoryCarveout, int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(static_cast<RaggedKernel>(decode_blocks_kernel),
                               cudaFuncAttributePreferredSharedMemoryCarveout, int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Launch the decoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_decode_blocks(const void* comp, const void* clens, const void* ulens,
                              int64_t rows, int64_t row_c, int64_t out_size, void* out,
                              void* ok, void* total, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaError_t err = prefer_shared();
  if (err != cudaSuccess) return err;
  static_cast<FixedKernel>(decode_blocks_kernel)<<<dim3(unsigned(rows)), kWarp, 0,
                                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      static_cast<const int32_t*>(ulens), row_c, out_size, static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(total));
  return cudaGetLastError();
}

// Launch the ragged variant over max_rows blocks on `stream`: the rows that
// rows[0] counts, as in_starts, clens, out_starts, ulens and streams give
// them (i64, i32, i64, i32, i32), of the comp_len bytes at comp into the
// out_len bytes at out; per row ok and total as above, and stream_ok
// cleared for each stream with a row that does not decode. Returns the
// launch's cudaError_t; does not synchronise.
int snappy_cuda_decode_segments(const void* comp, int64_t comp_len, const void* in_starts, const void* clens,
                                const void* out_starts, const void* ulens, const void* streams, const void* rows,
                                int64_t max_rows, void* out, int64_t out_len, void* ok, void* total,
                                void* stream_ok, void* stream) {
  if (max_rows <= 0) return cudaSuccess;
  cudaError_t err = prefer_shared();
  if (err != cudaSuccess) return err;
  const Ragged rag{static_cast<const int64_t*>(in_starts), static_cast<const int64_t*>(out_starts),
                   static_cast<const int32_t*>(streams), static_cast<uint8_t*>(stream_ok),
                   static_cast<const int64_t*>(rows), comp_len, out_len};
  static_cast<RaggedKernel>(decode_blocks_kernel)<<<dim3(unsigned(max_rows)), kWarp, 0,
                                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens), static_cast<const int32_t*>(ulens),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(ok), static_cast<int32_t*>(total), rag);
  return cudaGetLastError();
}

// The shared memory a block of the decoder takes, in bytes, and how many of
// its blocks one SM of the current device holds at once.
int snappy_cuda_decode_blocks_occupancy(int* smem_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, static_cast<FixedKernel>(decode_blocks_kernel));
  if (err != cudaSuccess) return err;
  *smem_bytes = int(attr.sharedSizeBytes);
  err = prefer_shared();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, static_cast<FixedKernel>(decode_blocks_kernel),
                                                       kWarp, 0);
}

const char* snappy_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
