// Segmenter of raw Snappy streams for Hopper (sm_90a), kernel K4: cuts each
// stream into the rows that K1's ragged variant (decode_blocks.cu) decodes in
// one launch. A short stream is walked by one two-warp block; a long one is
// cut into slices that blocks chart side by side, and the block that charts
// its last slice joins the charts along the stream's true chain of tags.
//
// It replaces no TPU kernel: the JAX package cuts a raw stream on the host
// (snappy_tpu/ops/host.py, with native/snappy_native.cpp::
// snappy_tpu_scan_blocks), one stream a call. This kernel applies that scan's
// rule on the card to many streams at unaligned offsets of one buffer, and
// gives, stream for stream, the starts and output lengths the scan gives:
// - a segment starts at the first tag boundary at or after every 64 KiB of
//   output since the last segment's start;
// - a segment is merged into its predecessor where a copy reaches behind its
//   start;
// - a stream whose segments would pass 128 KiB of output, or with a copy
//   offset above 0x1ffff or a literal above 0x1fff8 bytes, is one row (the
//   scan's "not segmentable");
// - a stream the scan proves corrupt is not ok and has no rows.
// Before the scan it checks each stream's varint header (at most 5 bytes,
// below 2**32) against the length the caller states, and the stream's and
// its output's place in their buffers.
//
//   in:  comp u8[comp_len], starts i64[n], clens i32[n] (a stream's bytes,
//        header included), ulens i32[n] (its stated output), out_starts i64[n]
//        (where its output goes in a buffer of out_len bytes), capacity (rows
//        the table holds); scratch: ctl (ctl_words(n) int64, zero on entry),
//        sums (pool summaries of kSumWords 16-byte words)
//   out: the rows: in i64, out i64 (absolute offsets into comp and out),
//        clen i32, ulen i32, stream i32; stream_ok u8[n]; ctl's first kStats
//        words: rows reserved, rows that hold segments, boundaries merged away,
//        streams taken whole, slices charted, slices met, slices walked.
// Stream s reserves ceil(ulen / 64 KiB) rows (no segment but the last holds
// less than 64 KiB of output) with one atomic add on stats[0]; the rows it
// does not fill are empty (clen = ulen = 0), which K1 decodes to nothing. A
// stream whose rows would pass `capacity` is not ok.
//
// What bounds it on the card: a tag's position depends on the one before
// it, so a stream's chain of tags is serial (~25 ns a tag for one block: a
// 257,588-tag page took 6.6 ms walked alone, the whole row group's K4 6.8).
// The design cuts each long chain into slices charted side by side:
// - The grid is as many two-warp blocks as the card holds at once (16 an SM,
//   64 registers a thread), each taking tasks until none is left: first the
//   streams, in turn (a shared count), then slices by ticket. A stream's task
//   checks its header and reserves its rows, then walks a body of at most
//   kSlice bytes whole; a longer one it lists, with ceil(body / kSlice)
//   slices and as many summary slots. A block with no stream left waits
//   only for the streams that running blocks took and have not listed yet
//   (microseconds); the tickets are then the slots in order, one atomic add
//   a slice.
// - A slice's task charts it: the chain from kRunIn bytes before the slice
//   (a guess; Snappy's tags fall into step within a few, so the chart meets
//   the stream's chain before the slice begins on ~98% of parquet pages'
//   slices), ignoring the scan's state, to the first position at or past the
//   slice's end, kept as 32 records, one a kSlice/32 bytes: where each starts,
//   the output before it and before its last tag, and the least
//   `output - offset` of its copies, or a flag for a tag the scan may refuse
//   (a zero or wide offset, a literal past the stream or above the limit).
//   ~75 us a 4 KiB slice with 16 blocks an SM; a row group's 34,224 slices
//   take ~1.4 ms of the card, which bounds K4 now.
// - The block that charts a stream's last slice (an atomic count and a fence)
//   joins them: from the stream's start, slice by slice, where the true chain
//   stands on a record's start, the records after it are taken whole while
//   none may hold a segment mark, a merge, a limit or a flag (one ballot of
//   32 lanes); a record that may is walked by the scan's rule, as is the true
//   chain until it stands on a record, and no walk passes the slice's end. So
//   the serial part is ~2 us a slice and a record (~64 tags) a segment: ~0.2
//   ms for a 300 KB page.
// A walk, whole or of a record, takes the parsing off the chain:
// - the stream passes through a ring of up to kRing bytes, staged with
//   16-byte loads from the 16-byte chunk that holds the next tag;
// - then, all lanes at once, a table of the step from every ring position
//   to the next tag (a copy's tag bytes, a short literal's bytes too), and
//   tables of the steps two and four tags on, built by doubling; a position
//   whose tag is a literal with a length trailer, runs past the ring, or lies
//   too near its end, stops them;
// - the chase follows the four-tag table (one shared load a step), up to 32
//   tags, and the lanes fill in the tags between from the two- and one-tag
//   tables, lane k keeping the k-th;
// - every lane reads its tag, a warp sum gives the batch's output, and one
//   ballot asks whether any tag may meet a segment mark, a copy that reaches
//   behind the segment, a limit or a fault (judged against the batch's start,
//   so it may ask too often, never too rarely); if none may, the 32 tags are
//   taken at once;
// - otherwise a warp scan gives each tag its own output position and the
//   ballot is asked again exactly; where a tag does meet one (about once
//   every 64 KiB of output), the 32 tags are stepped one by one by the scan's
//   own rule, every lane alike, and lane 0 writes the rows;
// - a block is two warps: both stage the ring and build its tables, the first
//   chases it.
// A chart chases the same way, with a warp scan, minimum and sum a batch in
// place of the scan's rule.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Compressed bytes a block stages at a time (a build may set it), and a
// slice's bytes (two rings unless a build sets it).
#ifndef SNAPPY_K4_RING
#define SNAPPY_K4_RING 2048
#endif
#ifndef SNAPPY_K4_SLICE
#define SNAPPY_K4_SLICE (2 * SNAPPY_K4_RING)
#endif
// Slices a block charts before it leaves: no limit, unless a test build sets
// one so that other blocks chart and join the rest.
#ifndef SNAPPY_K4_CLAIMS
#define SNAPPY_K4_CLAIMS 0x7fffffff
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 64;  // two warps: both stage and chart the ring, the first walks it
constexpr uint32_t kRing = SNAPPY_K4_RING;
constexpr uint32_t kSlice = SNAPPY_K4_SLICE;
constexpr uint32_t kRunIn = kSlice / 16;    // bytes before a slice its chart chases first
constexpr int kRecords = kWarp;             // a slice's records, one a lane
constexpr uint32_t kGap = kSlice / kRecords;  // a record closes once the chain passes each kGap bytes
constexpr int kSumWords = 1 + kRecords;     // 16-byte words of a slice's summary
constexpr int kClaims = SNAPPY_K4_CLAIMS;
constexpr uint32_t kPad = 4;                 // bytes a tag's trailer may read past it
constexpr uint32_t kBlock = 1u << 16;        // a segment closes at a tag at or past this output
constexpr uint32_t kMaxSegment = 1u << 17;   // the most output a segment may hold
constexpr uint32_t kMaxOffset = 0x1ffff;     // the largest copy offset a segmented stream may hold
constexpr uint64_t kMaxLiteral = 0x1fff8;    // the longest literal a segmented stream may hold
constexpr int kSegmented = 0, kWhole = -1, kCorrupt = -2;
constexpr uint32_t kStop = 0xFF;  // a table entry no step crosses (a step is at most 4 x 61 bytes)
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int32_t kNoReach = 0x7fffffff;     // a record's least reach where it holds no copy
constexpr int32_t kFlag = -0x7fffffff - 1;   // ... where it holds a tag the scan may refuse
constexpr int kStats = 7;
static_assert(kRing % 16 == 0 && kRing >= 64, "the ring holds whole 16-byte chunks, 64 bytes or more");
static_assert(kSlice % kRecords == 0 && kSlice >= 2 * kRecords && kSlice % 16 == 0, "a slice is whole records");

// The scratch: ctl holds the counts, then the list's counters (streams
// listed, tickets taken, summary slots taken, streams taken, streams listed
// or walked), a Long a stream and an owner word a slot; sums a summary a
// slot.
struct Long {
  int64_t base;  // its first row
  uint32_t stream, pool, slices, done;  // pool: its first slot; done: its slices charted
  int64_t spare;
};
static_assert(sizeof(Long) == 32, "a Long is four words of ctl");
constexpr int64_t kCtlHead = kStats + 5;
// Summary slots enough for every stream of n that lie apart in comp_len bytes.
inline int64_t pool_for(int64_t comp_len, int64_t n) { return comp_len / kSlice + n + 1; }
inline int64_t ctl_words(int64_t comp_len, int64_t n) { return kCtlHead + 4 * n + (pool_for(comp_len, n) + 1) / 2; }

struct Work {
  unsigned long long* list;
  Long* longs;
  uint32_t* owner;  // a slot's stream's entry + 1, or 0
  uint4* sums;
  uint64_t pool;
};

// The rows K4 writes.
struct Rows {
  int64_t* in;
  int64_t* out;
  int32_t* clen;
  int32_t* ulen;
  int32_t* stream;
};

// A block's shared memory: the ring, its tables, and what the first warp
// tells the block.
struct Smem {
  __align__(16) uint8_t ring[kRing];
  uint8_t step1[kRing];
  uint8_t step2[kRing];
  uint8_t step4[kRing];
  uint8_t advance[256];
  unsigned long long base;
  uint32_t from, len, entry, slice, stream, slices, pool, listed;
  bool last;
  int64_t lbase;
};

// Tag-decode LUT entry of tag byte c: bits 0..7 length, 8..10 copy offset
// high bits pre-shifted, 11..13 number of trailer bytes. Same table as
// snappy_tpu_torch/core/constants.py::CHAR_TABLE and decode_blocks.cu.
__device__ __forceinline__ uint32_t tag_entry(uint32_t c) {
  const uint32_t hi6 = c >> 2, type = c & 3u;
  const bool long_lit = type == 0 && hi6 >= 60;
  const uint32_t len = type == 1 ? 4 + (hi6 & 7u) : (long_lit ? 1u : hi6 + 1);
  const uint32_t off = type == 1 ? ((c >> 5) & 7u) << 8 : 0u;
  const uint32_t taglen = type == 0 ? (long_lit ? hi6 - 59 : 0u) : (type == 3 ? 4u : type);
  return len | off | (taglen << 11);
}

__device__ __forceinline__ uint32_t lesser(uint32_t a, uint32_t b) { return a < b ? a : b; }

// The low `bytes` bytes of `word` (bytes <= 4).
__device__ __forceinline__ uint32_t low_bytes(uint32_t word, uint32_t bytes) {
  return bytes >= 4 ? word : word & ((1u << (8 * bytes)) - 1u);
}

template <class T> __device__ __forceinline__ T vload(const T& x) { return *const_cast<const volatile T*>(&x); }

// A stream's place: its body's first byte sits `shift` bytes into its
// 16-byte chunk where comp is aligned, and positions are counted from that
// chunk's start (ring coordinates).
struct Stream {
  const uint8_t* src;
  int64_t body, out0;
  uint32_t shift, n, in_end, have, ulen, cap;
  bool ok;
};

// Stream s's place, and whether it and its output lie in their buffers with
// a varint header (at most 5 bytes, the fifth below 0x10) equal to the
// stated length. Every thread computes the same.
__device__ __forceinline__ Stream open_stream(const uint8_t* __restrict__ comp, int64_t comp_len, const int64_t* starts,
                                              const int32_t* clens, const int32_t* ulens, const int64_t* out_starts,
                                              int64_t out_len, int64_t s, bool wide) {
  Stream g;
  const int64_t start = starts[s], clen = clens[s], ulen = ulens[s];
  g.out0 = out_starts[s];
  bool ok = start >= 0 && clen >= 0 && start <= comp_len - clen && ulen >= 0 && g.out0 >= 0 &&
            g.out0 <= out_len - ulen;
  uint32_t hdr = 0;
  if (ok) {
    uint64_t value = 0;
    bool done = false;
    for (uint32_t k = 0; k < 5 && !done; ++k) {
      if (int64_t(k) >= clen) break;
      const uint32_t b = comp[start + k];
      if (k == 4 && b >= 0x10) break;
      value |= uint64_t(b & 0x7F) << (7 * k);
      hdr = k + 1;
      done = b < 0x80;
    }
    ok = done && value == uint64_t(ulen);
  }
  g.ok = ok;
  g.cap = ok ? uint32_t((ulen + kBlock - 1) >> 16) : 0u;
  g.body = start + hdr;
  g.shift = ok && wide ? uint32_t(g.body & 15) : 0u;
  g.n = ok ? uint32_t(clen - hdr) + g.shift : 0u;
  g.ulen = ok ? uint32_t(ulen) : 0u;
  g.src = comp + (ok ? g.body - g.shift : 0);
  g.in_end = g.n + kPad;
  const int64_t have = ok ? comp_len - (g.body - g.shift) : 0;
  g.have = uint32_t(have < int64_t(g.in_end) ? have : int64_t(g.in_end));
  return g;
}

// The ring := src bytes [base, end): from `at` rounded down to 16, `len` of
// them (at most kRing, a multiple of 16) or up to in_end, those at or past
// `have` as zeros. All threads call it, between two block barriers.
__device__ __forceinline__ void stage(uint8_t* ring, const uint8_t* __restrict__ src, uint32_t at, uint32_t len,
                                      uint32_t in_end, uint32_t have, bool wide, int tid, uint32_t& base,
                                      uint32_t& end) {
  base = at & ~15u;
  end = lesser(base + len, in_end);
  const uint32_t real = lesser(end, have);
  uint32_t i = tid;
  if (wide) {
    const uint32_t n16 = (real - base) >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
    uint4* r4 = reinterpret_cast<uint4*>(ring);
    for (uint32_t k = tid; k < n16; k += kThreads) r4[k] = s4[k];
    i = (n16 << 4) + tid;
  }
  for (; i < real - base; i += kThreads) ring[i] = src[base + i];
  for (; i < end - base; i += kThreads) ring[i] = 0;
}

// The tables of the ring [base, end): step1[i], the bytes from ring position
// base + i to the next tag; step2[i] and step4[i], to the tag two and four
// on. kStop where the tag is a literal with a length trailer or runs past the
// ring, where its 5 bytes do not all lie in the ring, where it is past the
// stream's last tag, or (step2, step4) where a tag the step crosses is so.
// `advance` is step1 by tag byte alone. Each thread takes kUnroll positions
// at a time, so that their loads overlap. All threads call it, after a block
// barrier; it ends with one.
constexpr int kUnroll = 4;

// to[i] := from[i] + from[i + from[i]], or kStop.
__device__ __forceinline__ void double_steps(const uint8_t* from, uint8_t* to, uint32_t len, int tid) {
  for (uint32_t i0 = tid; i0 < len; i0 += kUnroll * kThreads) {
    uint32_t a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads;
      a[u] = i < len ? from[i] : kStop;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t j = i0 + u * kThreads + a[u];
      b[u] = a[u] != kStop && j < len ? from[j] : kStop;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads;
      if (i < len) to[i] = uint8_t(b[u] == kStop ? kStop : a[u] + b[u]);
    }
  }
}

__device__ __forceinline__ void chart(Smem& sm, uint32_t base, uint32_t end, uint32_t n, int tid) {
  const uint32_t len = end - base;
  for (uint32_t i0 = tid; i0 < len; i0 += kUnroll * kThreads) {
    uint32_t d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads;
      d[u] = i < len ? sm.advance[sm.ring[i]] : kStop;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads, q = base + i;
      if (i < len) sm.step1[i] = uint8_t(q + 1 < n && q + 5 <= end && q + d[u] <= end ? d[u] : kStop);
    }
  }
  __syncthreads();
  double_steps(sm.step1, sm.step2, len, tid);
  __syncthreads();
  double_steps(sm.step2, sm.step4, len, tid);
  __syncthreads();
}

// The tag byte at t and the 4 bytes after it (little-endian).
__device__ __forceinline__ void read_tag(const uint8_t* t, uint32_t& c, uint32_t& word) {
  c = t[0];
  word = uint32_t(t[1]) | uint32_t(t[2]) << 8 | uint32_t(t[3]) << 16 | uint32_t(t[4]) << 24;
}

// The chase: up to 32 tags of the chain from ip, each at a position before
// lim (at most the ring's end), four at a time while the table allows, then
// one at a time; lane k keeps the k-th's position in `at`. Returns how many,
// 0 where the tables stop at ip's tag; next_ip becomes the position after
// them.
__device__ __forceinline__ uint32_t chase(const Smem& sm, uint32_t rbase, uint32_t lim, uint32_t ip,
                                          uint32_t& next_ip, uint32_t& at, int lane) {
  uint32_t nb = 0, at4 = 0;
  next_ip = ip;
  for (; nb + 4 <= uint32_t(kWarp) && next_ip < lim; nb += 4) {
    const uint32_t d = sm.step4[next_ip - rbase];
    if (d == kStop || next_ip + d > lim) break;
    if (lane == int(nb >> 2)) at4 = next_ip;
    next_ip += d;
  }
  at = __shfl_sync(kFull, at4, lane >> 2);
  if (uint32_t(lane) < nb) {
    if (lane & 2) at += sm.step2[at - rbase];
    if (lane & 1) at += sm.step1[at - rbase];
  }
  for (; nb < uint32_t(kWarp) && next_ip < lim; ++nb) {
    const uint32_t d = sm.step1[next_ip - rbase];
    if (d == kStop) break;
    if (lane == int(nb)) at = next_ip;
    next_ip += d;
  }
  return nb;
}

// A stream's scan state, the same in every lane.
struct Scan {
  uint32_t n;          // the body's end, in ring coordinates (its first byte is at `shift`)
  uint32_t shift;
  uint32_t ulen;
  uint32_t op = 0, blk = 0, seg_start = 0, merged = 0;
  uint32_t cap;        // rows reserved
  int64_t base;        // the first of them
  uint32_t owned;      // those of them inside the table
};

// One tag of the scan (native/snappy_native.cpp::snappy_tpu_scan_blocks, the
// body of its loop), at ring position `at` with tag byte c and the 4 bytes
// after it in `word`; returns kSegmented to go on, or kWhole or kCorrupt.
// `ip` becomes the next tag's position. Lane 0 writes the rows; every lane
// keeps the same state.
__device__ __forceinline__ int scan_step(Scan& s, const Rows& rows, uint32_t at, uint32_t c, uint32_t word,
                                         uint32_t& ip, int lane) {
  if (s.op - s.seg_start >= kBlock || s.blk == 0) {
    if (s.op >= s.ulen && !(s.blk == 0 && s.ulen == 0)) return kCorrupt;
    if (s.blk == s.cap) return kCorrupt;
    if (lane == 0) {
      if (s.blk > 0) rows.ulen[s.base + s.blk - 1] = int32_t(s.op - s.seg_start);
      rows.in[s.base + s.blk] = at - s.shift;
      rows.out[s.base + s.blk] = s.op;
    }
    s.seg_start = s.op;
    ++s.blk;
  }
  const uint32_t entry = tag_entry(c);
  const uint32_t taglen = entry >> 11;
  // Trailer bytes past the stream read as zeros.
  const uint32_t trailer = low_bytes(word, lesser(taglen, s.n - (at + 1)));
  const uint32_t len = entry & 0xFF;
  ip = at + 1 + taglen;
  if ((c & 3u) != 0) {
    const uint32_t offset = (entry & 0x700) + trailer;
    if (offset == 0 || s.op < offset || s.ulen - s.op < len) return kCorrupt;
    // A copy that reaches behind its segment's start merges the segment into
    // the one before it, as often as it takes.
    while (s.op - offset < s.seg_start) {
      if (s.blk < 2) return kWhole;
      --s.blk;
      int32_t before = 0;
      if (lane == 0) before = rows.ulen[s.base + s.blk - 1];
      s.seg_start -= uint32_t(__shfl_sync(0xFFFFFFFFu, before, 0));
      ++s.merged;
    }
    if (offset > kMaxOffset) return kWhole;
    s.op += len;
  } else {
    const uint64_t lit = uint64_t(len) + trailer;
    if (ip > s.n || s.n - ip < lit || s.ulen - s.op < lit) return kCorrupt;
    if (lit > kMaxLiteral) return kWhole;
    ip += uint32_t(lit);
    s.op += uint32_t(lit);
  }
  if (s.op - s.seg_start > kMaxSegment) return kWhole;
  return kSegmented;
}

// A slice's chart, kept by the first warp: the chain from kRunIn bytes
// before the slice [lo, hi) (from lo for the first) to the first position at
// or past hi, and its records from the first position at or past lo, lane r
// keeping record r: where it starts, the output before it (from the first
// record's start) and before its last tag, and the least `output - offset`
// of its copies, or kFlag where a tag in it may be refused.
struct Chart {
  uint32_t ip, lo, hi, n;
  bool counting = false;
  uint32_t tot = 0, rec = 0;
  uint32_t r_pos = 0, r_before = 0, r_last = 0;
  int32_t r_least = kNoReach;

  __device__ __forceinline__ void open_record(int lane) {
    if (lane == int(rec)) {
      r_pos = ip;
      r_before = r_last = tot;
      r_least = kNoReach;
    }
  }

  // A record closes once the chain passes its kGap bytes; the last holds
  // the rest.
  __device__ __forceinline__ void step_to(uint32_t next_ip, int lane) {
    ip = next_ip;
    if (counting && ip < hi && ip + 1 < n && rec + 1 < uint32_t(kRecords) && ip >= lo + (rec + 1) * kGap) {
      ++rec;
      open_record(lane);
    }
  }

  // Chases the ring [rbase, rend); returns where to stage from next, or ~0u
  // once the chain is at or past hi.
  __device__ uint32_t next(const Smem& sm, uint32_t rbase, uint32_t rend, uint32_t& len, int lane) {
    for (;;) {
      if (!counting && ip >= lo) {
        counting = true;
        open_record(lane);
      }
      if (ip >= hi || ip + 1 >= n) return ~0u;
      if (ip < rbase || ip + 5 > rend) {
        // The ring, or what is left of the slice and its last tag's bytes.
        len = lesser(kRing, (hi + kPad - (ip & ~15u) + 16) & ~15u);
        return ip;
      }
      uint32_t next_ip, at;
      const uint32_t nb = chase(sm, rbase, lesser(rend, counting ? hi : lo), ip, next_ip, at, lane);
      if (nb == 0) {
        // One tag alone: a literal with a length trailer or past the ring.
        uint32_t c, word;
        read_tag(sm.ring + (ip - rbase), c, word);
        const uint32_t entry = tag_entry(c), taglen = entry >> 11, tag_end = ip + 1 + taglen;
        const uint32_t trailer = low_bytes(word, lesser(taglen, n - (ip + 1)));
        uint64_t out = entry & 0xFF, after = tag_end;
        int32_t reach;
        if ((c & 3u) == 0) {
          out += trailer;
          after += out;
          reach = tag_end > n || n - tag_end < out || out > kMaxLiteral ? kFlag : kNoReach;
        } else {
          const uint32_t f = (entry & 0x700) + trailer;
          reach = tag_end > n || f == 0 || f > kMaxOffset ? kFlag : int32_t(tot) - int32_t(f);
        }
        if (counting) {
          if (lane == int(rec)) {
            r_least = reach < r_least ? reach : r_least;
            r_last = tot;
          }
          tot += uint32_t(out);
        }
        step_to(after < n ? uint32_t(after) : n, lane);
        continue;
      }
      if (counting) {
        const bool mine = uint32_t(lane) < nb;
        uint32_t c = 0, word = 0;
        if (mine) read_tag(sm.ring + (at - rbase), c, word);
        const uint32_t entry = tag_entry(c);
        const uint32_t taglen = entry >> 11;
        const uint32_t tag_end = at + 1 + taglen;
        const bool lit = (c & 3u) == 0;
        const uint32_t len = mine ? entry & 0xFF : 0;
        const uint32_t f = (entry & 0x700) + (taglen ? word & (0xFFFFFFFFu >> (32 - 8 * taglen)) : 0);
        uint32_t end = len;  // the output up to this tag's end in the batch (a warp scan)
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, end, d);
          if (lane >= d) end += v;
        }
        const bool flag = tag_end > n || (lit ? len > n - tag_end : f == 0 || f > kMaxOffset);
        const int32_t reach = !mine ? kNoReach : flag ? kFlag : lit ? kNoReach : int32_t(tot + end - len) - int32_t(f);
        const int32_t least = __reduce_min_sync(kFull, reach);
        const uint32_t last = tot + __shfl_sync(kFull, end - len, nb - 1);
        if (lane == int(rec)) {
          r_least = least < r_least ? least : r_least;
          r_last = last;
        }
        tot += __shfl_sync(kFull, end, kWarp - 1);
      }
      step_to(next_ip, lane);
    }
  }

  // The summary: its record count, exit and total, then the records.
  __device__ __forceinline__ void write(uint4* sum, int lane) const {
    if (lane == 0) sum[0] = make_uint4(rec + 1, ip, tot, 0u);
    if (uint32_t(lane) <= rec) sum[1 + lane] = make_uint4(r_pos, r_before, r_last, uint32_t(r_least));
  }
};

// A stream's scan, kept by the first warp: walked whole where `sums` is
// null, else joined from its slices' summaries.
struct Join {
  Scan s;
  uint32_t ip;
  int status;
  const uint4* sums;
  uint32_t slices;
  uint32_t k = ~0u, entered = 0, met = 0, walked = 0;
  bool walked_k = false, walking = false;
  uint32_t lim = 0;  // a walk goes on to the first position at or past it
  // Slice k's summary: its record count, exit and total; lane r's record r,
  // where it ends and the output before its end.
  uint32_t count = 0, exit = 0, total = 0, pos = 0, before = 0, last = 0, end = 0, after = 0;
  int32_t least = 0;

  __device__ __forceinline__ void walk_to(uint32_t target) {
    walking = true;
    lim = target;
    walked += !walked_k;
    walked_k = true;
  }

  __device__ __forceinline__ void load(uint32_t slice, int lane) {
    const uint4* sum = sums + size_t(slice) * kSumWords;
    const uint4 h = __ldcg(sum), r = __ldcg(sum + 1 + lane);
    count = h.x;
    exit = h.y;
    total = h.z;
    pos = r.x;
    before = r.y;
    last = r.z;
    least = int32_t(r.w);
    const uint32_t next_pos = __shfl_down_sync(kFull, pos, 1), next_before = __shfl_down_sync(kFull, before, 1);
    end = uint32_t(lane) + 1 < count ? next_pos : exit;
    after = uint32_t(lane) + 1 < count ? next_before : total;
  }

  // The scan's rule on the ring [rbase, rend) from ip, up to lim.
  __device__ void walk(const Smem& sm, const Rows& rows, uint32_t rbase, uint32_t rend, int lane) {
    const uint32_t stop = lesser(lim, rend);
    while (status == kSegmented && ip + 1 < s.n && ip + 5 <= rend && ip < lim) {
      uint32_t next_ip, at;
      const uint32_t nb = chase(sm, rbase, stop, ip, next_ip, at, lane);
      if (nb == 0) {
        // One tag alone: a literal with a length trailer or past the ring.
        uint32_t c, word;
        read_tag(sm.ring + (ip - rbase), c, word);
        status = scan_step(s, rows, ip, c, word, ip, lane);
        continue;
      }
      // Each lane reads its tag; a warp sum gives the batch's output.
      const bool mine = uint32_t(lane) < nb;
      uint32_t c = 0, word = 0;
      if (mine) read_tag(sm.ring + (at - rbase), c, word);
      const uint32_t entry = tag_entry(c);
      const uint32_t taglen = entry >> 11;
      const uint32_t tag_end = at + 1 + taglen;
      const bool lit = (c & 3u) == 0;
      const uint32_t len = mine ? entry & 0xFF : 0;
      const uint32_t f = (entry & 0x700) + (taglen ? word & (0xFFFFFFFFu >> (32 - 8 * taglen)) : 0);
      const uint32_t total_b = __reduce_add_sync(kFull, len);
      // Whatever the fast path might not take, judged against the batch's
      // start (`into` bytes of output into its segment; a tag's own output
      // position is at least that far in): a segment mark, a copy that may
      // reach behind the segment's start or the output's, more output than
      // stated, a tag or literal past the stream, a limit.
      const uint32_t into = s.op - s.seg_start;
      bool event =
          s.blk == 0 || into + total_b >= kBlock || total_b > s.ulen - s.op ||
          __ballot_sync(kFull, mine && (tag_end > s.n || (lit ? len > s.n - tag_end
                                                              : f == 0 || f > into || f > kMaxOffset)));
      if (event) {
        // The same, exactly: each tag at its own output position (a warp
        // scan).
        uint32_t end_b = len;
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, end_b, d);
          if (lane >= d) end_b += v;
        }
        const uint32_t at_op = s.op + end_b - len;
        event = s.blk == 0 ||
                __ballot_sync(kFull, mine && (tag_end > s.n || at_op > s.ulen || len > s.ulen - at_op ||
                                              at_op - s.seg_start >= kBlock || at_op + len - s.seg_start > kMaxSegment ||
                                              (lit ? len > s.n - tag_end
                                                   : f == 0 || f > at_op || at_op - f < s.seg_start || f > kMaxOffset)));
      }
      if (!event) {
        s.op += total_b;
        ip = next_ip;
        continue;
      }
      // The scan's own rule, tag by tag.
      for (uint32_t t = 0; t < nb && status == kSegmented; ++t) {
        const uint32_t tag_at = __shfl_sync(kFull, at, t);
        const uint32_t tag_c = __shfl_sync(kFull, c, t);
        const uint32_t tag_word = __shfl_sync(kFull, word, t);
        status = scan_step(s, rows, tag_at, tag_c, tag_word, ip, lane);
      }
    }
  }

  // Goes as far as the summaries and the ring [rbase, rend) allow; returns
  // where to stage from next (`len` bytes), or ~0u once the scan is over.
  __device__ uint32_t next(const Smem& sm, const Rows& rows, uint32_t rbase, uint32_t rend, uint32_t& len, int lane) {
    for (;;) {
      if (status != kSegmented || ip + 1 >= s.n) return ~0u;
      if (walking && ip < lim) {
        if (ip < rbase || ip + 5 > rend) {
          // The ring a walk needs: the whole ring, or a record's bytes.
          len = lesser(kRing, (lim - (ip & ~15u) + 32 + 15) & ~15u);
          return ip;
        }
        walk(sm, rows, rbase, rend, lane);
        continue;
      }
      walking = false;
      if (!sums) {
        walk_to(s.n);
        continue;
      }
      const uint32_t kk = (ip - s.shift) / kSlice;
      if (kk != k) {
        k = kk;
        load(k, lane);
        ++entered;
        walked_k = false;
        met += __ballot_sync(kFull, uint32_t(lane) < count && pos == ip) != 0;
      }
      // The first record at or past ip: walk to it, or take the records from
      // it on up to the first that may hold an event.
      const uint32_t ahead = __ballot_sync(kFull, uint32_t(lane) < count && pos >= ip);
      const uint32_t r = ahead ? __ffs(ahead) - 1 : count;
      const uint32_t r_pos = __shfl_sync(kFull, pos, r & 31u);
      // No walk passes the slice's end, where the next slice's chart takes
      // over: a chart whose chain is not the stream's may end anywhere.
      const uint32_t slice_end = s.shift + (k + 1) * kSlice;
      const uint32_t target = r < count ? lesser(r_pos, slice_end) : slice_end;
      if (ip < target) {
        walk_to(target);
        continue;
      }
      const uint32_t b0 = __shfl_sync(kFull, before, r);
      const uint32_t op_at = s.op + (before - b0), op_end = s.op + (after - b0);
      const bool quiet = pos == end || (s.blk != 0 && op_at + (last - before) - s.seg_start < kBlock &&
                                        int64_t(s.op) + least - int64_t(b0) >= int64_t(s.seg_start) &&
                                        op_end <= s.ulen && op_end - s.seg_start <= kMaxSegment);
      const uint32_t loud = __ballot_sync(kFull, uint32_t(lane) >= r && uint32_t(lane) < count && !quiet);
      const uint32_t r1 = loud ? __ffs(loud) - 1 : count;
      const uint32_t pos1 = __shfl_sync(kFull, pos, r1 & 31u), before1 = __shfl_sync(kFull, before, r1 & 31u);
      const uint32_t end1 = __shfl_sync(kFull, end, r1 & 31u);
      s.op += (r1 < count ? before1 : total) - b0;
      ip = r1 < count ? pos1 : exit;
      if (r1 < count) walk_to(lesser(end1, slice_end));
    }
  }

  // The rows: the segments (closed here), the whole stream, or none; the
  // rest of the reservation empty. Then the stream's flag and counts.
  __device__ void finish(const Rows& rows, const Stream& g, int64_t stream, uint8_t* stream_ok,
                         unsigned long long* stats, int lane) {
    if (status == kSegmented && s.op != s.ulen) status = kCorrupt;
    __syncwarp();
    uint32_t used = 0;
    if (status == kSegmented) {
      if (lane == 0 && s.blk > 0) rows.ulen[s.base + s.blk - 1] = int32_t(s.op - s.seg_start);
      used = s.blk;
    } else if (status == kWhole) {
      if (lane == 0) {
        rows.in[s.base] = 0;
        rows.out[s.base] = 0;
        rows.ulen[s.base] = int32_t(s.ulen);
      }
      used = 1;
    }
    __syncwarp();
    // Each lane reads its rows' relative starts before any lane rewrites them.
    const uint32_t body_n = s.n - s.shift;
    for (uint32_t k0 = 0; k0 < s.owned; k0 += kWarp) {
      const uint32_t r = k0 + lane;
      const int64_t row = s.base + r;
      int64_t in_rel = 0, next_in = 0, out_rel = 0;
      if (r < used) {
        in_rel = rows.in[row];
        next_in = r + 1 < used ? rows.in[row + 1] : int64_t(body_n);
        out_rel = rows.out[row];
      }
      __syncwarp();
      if (r < used) {
        rows.in[row] = g.body + in_rel;
        rows.out[row] = g.out0 + out_rel;
        rows.clen[row] = int32_t(next_in - in_rel);
      } else if (r < s.owned) {
        rows.in[row] = 0;
        rows.out[row] = 0;
        rows.clen[row] = 0;
        rows.ulen[row] = 0;
      }
      if (r < s.owned) rows.stream[row] = int32_t(stream);
      __syncwarp();
    }
    if (lane == 0) {
      stream_ok[stream] = status != kCorrupt;
      if (used) atomicAdd(&stats[1], (unsigned long long)used);
      if (status == kSegmented && s.merged) atomicAdd(&stats[2], (unsigned long long)s.merged);
      if (status == kWhole) atomicAdd(&stats[3], 1ull);
      if (sums) {
        // A slice the join never entered (a literal spans it) counts as met.
        atomicAdd(&stats[5], (unsigned long long)(met + slices - entered));
        atomicAdd(&stats[6], (unsigned long long)walked);
      }
    }
  }
};

__device__ __forceinline__ Join join_of(const Stream& g, int64_t base, uint32_t owned, bool ok, const uint4* sums,
                                        uint32_t slices) {
  Join j;
  j.s.n = g.n;
  j.s.shift = g.shift;
  j.s.ulen = g.ulen;
  j.s.cap = g.cap;
  j.s.base = base;
  j.s.owned = owned;
  j.ip = g.shift;
  j.status = ok ? kSegmented : kCorrupt;
  j.sums = sums;
  j.slices = slices;
  return j;
}

// Runs a task on the ring: `step`, called by the first warp with the ring
// [rbase, rend) (empty at first), goes as far as it can and returns where to
// stage from next (~0u once the task is done) and how many bytes; both warps
// stage and chart them.
template <class Step>
__device__ __forceinline__ void drive(Smem& sm, const Stream& g, bool wide, int tid, Step step) {
  uint32_t rbase = 0, rend = 0;
  for (;;) {
    if (tid < kWarp) {
      uint32_t len = kRing;
      const uint32_t from = step(rbase, rend, len);
      if (tid == 0) {
        sm.from = from;
        sm.len = len;
      }
    }
    __syncthreads();
    const uint32_t from = sm.from, len = sm.len;
    __syncthreads();
    if (from == ~0u) return;
    stage(sm.ring, g.src, from, len, g.in_end, g.have, wide, tid, rbase, rend);
    __syncthreads();
    chart(sm, rbase, rend, g.n, tid);
  }
}

// A slot for this block (tid 0), by ticket: tickets are the slots in order
// (one atomic add a claim), taken once every stream is listed or walked, so
// that each slot below the count taken is its stream's (or no stream's,
// where the slots ran out). False once the tickets pass that count.
__device__ bool ticket(const Work& w, uint32_t& entry, uint32_t& slot) {
  for (;;) {
    const unsigned long long t = atomicAdd(&w.list[1], 1ull);
    if (t >= vload(w.list[2]) || t >= w.pool) return false;
    const uint32_t owner = vload(w.owner[t]);
    if (owner) {
      entry = owner - 1;
      slot = uint32_t(t);
      return true;
    }
  }
}

// Every block takes tasks until none is left: first the streams, in turn (a
// shared count), then the listed slices by ticket. A stream's task checks its
// header and reserves its rows, then walks it whole, or lists its slices. A
// slice's task charts it, and joins its stream where it was the stream's last
// to be charted. A block waits only for streams that running blocks took and
// have not yet listed or begun to walk, so the result holds whatever the
// order in which blocks run (one at a time in the tests' host emulation).
__global__ void __launch_bounds__(kThreads)
segment_streams_kernel(const uint8_t* __restrict__ comp, int64_t comp_len, const int64_t* __restrict__ starts,
                       const int32_t* __restrict__ clens, const int32_t* __restrict__ ulens,
                       const int64_t* __restrict__ out_starts, int64_t out_len, int64_t n_streams, int64_t capacity,
                       const Rows rows, uint8_t* __restrict__ stream_ok, unsigned long long* stats, const Work work) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  for (uint32_t c = tid; c < 256; c += kThreads) {
    const uint32_t entry = tag_entry(c);
    sm.advance[c] = uint8_t(c & 3u ? 1 + (entry >> 11) : (entry >> 11) == 0 ? 1 + (entry & 0xFF) : kStop);
  }
  const bool wide = (reinterpret_cast<uintptr_t>(comp) & 15) == 0;
  int claims = 0;
  for (;;) {
    if (tid == 0) {
      // The streams first, then tickets, once the streams other blocks took
      // are listed or walked (they are running: a few microseconds).
      unsigned long long stream = ~0ull;
      uint32_t entry = 0, slot = 0;
      if (vload(work.list[3]) < (unsigned long long)n_streams) stream = atomicAdd(&work.list[3], 1ull);
      if (stream >= (unsigned long long)n_streams) {
        while (vload(work.list[4]) < (unsigned long long)n_streams) __nanosleep(128);
        __threadfence();
      }
      if (stream < (unsigned long long)n_streams) {
        sm.entry = ~0u;
        sm.stream = uint32_t(stream);
      } else if (claims < kClaims && ticket(work, entry, slot)) {
        __threadfence();
        const Long& l = work.longs[entry];
        sm.entry = entry;
        sm.stream = vload(l.stream);
        sm.slices = vload(l.slices);
        sm.pool = vload(l.pool);
        sm.slice = slot - sm.pool;
        sm.lbase = vload(l.base);
      } else {
        sm.entry = sm.stream = ~0u;
      }
    }
    __syncthreads();
    const uint32_t entry = sm.entry, slice = sm.slice, slices = sm.slices, pool = sm.pool;
    const int64_t stream = sm.stream, base = sm.lbase;
    __syncthreads();
    if (entry == ~0u && stream == ~0u) return;
    const Stream g = open_stream(comp, comp_len, starts, clens, ulens, out_starts, out_len, stream, wide);

    if (entry == ~0u) {
      // A stream: its rows, then its walk, or its slices listed.
      if (tid == 0) {
        const unsigned long long first = g.cap ? atomicAdd(&stats[0], (unsigned long long)g.cap) : 0ull;
        const uint32_t count = (g.n - g.shift + kSlice - 1) / kSlice;
        uint32_t listed = ~0u, taken = 0;
        if (g.ok && count > 1 && int64_t(first) + g.cap <= capacity) {
          const unsigned long long pool = atomicAdd(&work.list[2], (unsigned long long)count);
          if (pool + count <= work.pool) {
            listed = uint32_t(atomicAdd(&work.list[0], 1ull));
            taken = uint32_t(pool);
            Long& l = work.longs[listed];
            l.base = int64_t(first);
            l.stream = uint32_t(stream);
            l.pool = taken;
            l.slices = count;
          }
        }
        sm.base = first;
        sm.listed = listed;
        sm.pool = taken;
        sm.slices = count;
      }
      __syncthreads();
      const int64_t first = int64_t(sm.base);
      const uint32_t listed = sm.listed;
      if (listed != ~0u)
        for (uint32_t i = tid; i < sm.slices; i += kThreads) work.owner[sm.pool + i] = listed + 1;
      __threadfence();
      __syncthreads();
      if (tid == 0) atomicAdd(&work.list[4], 1ull);
      if (listed != ~0u) continue;
      const int64_t room = capacity - first;
      const uint32_t owned = room <= 0 ? 0u : room < int64_t(g.cap) ? uint32_t(room) : g.cap;
      Join j = join_of(g, first, owned, g.ok && owned == g.cap, nullptr, 0);
      drive(sm, g, wide, tid, [&](uint32_t rbase, uint32_t rend, uint32_t& len) {
        return j.next(sm, rows, rbase, rend, len, lane);
      });
      if (tid < kWarp) j.finish(rows, g, stream, stream_ok, stats, lane);
      continue;
    }

    // A slice: its chart; then the join, where it was the stream's last.
    ++claims;
    uint4* sums = work.sums + size_t(pool) * kSumWords;
    const uint32_t lo = g.shift + slice * kSlice;
    Chart ch;
    ch.ip = slice ? lo - kRunIn : lo;
    ch.lo = lo;
    ch.hi = lesser(lo + kSlice, g.n);
    ch.n = g.n;
    drive(sm, g, wide, tid, [&](uint32_t rbase, uint32_t rend, uint32_t& len) { return ch.next(sm, rbase, rend, len, lane); });
    if (tid < kWarp) ch.write(sums + size_t(slice) * kSumWords, lane);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&stats[4], 1ull);
      sm.last = atomicAdd(&work.longs[entry].done, 1u) + 1 == slices;
    }
    __syncthreads();
    const bool last = sm.last;
    __syncthreads();
    if (!last) continue;
    __threadfence();
    Join j = join_of(g, base, g.cap, true, sums, slices);
    drive(sm, g, wide, tid, [&](uint32_t rbase, uint32_t rend, uint32_t& len) {
      return j.next(sm, rows, rbase, rend, len, lane);
    });
    if (tid < kWarp) j.finish(rows, g, stream, stream_ok, stats, lane);
  }
}

}  // namespace

extern "C" {

// Blocks of K4 need the largest shared-memory carveout. The preference
// belongs to the current device; it is set once on each (on devices past the
// 64th, at every call).
static cudaError_t prefer_shared() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(segment_streams_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The blocks of K4 the current device holds at once (asked once a device;
// 0 on an error).
static int64_t resident() {
  static std::atomic<int64_t> known[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && known[dev].load(std::memory_order_relaxed)) return known[dev].load(std::memory_order_relaxed);
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_streams_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const int64_t blocks = int64_t(sms) * per_sm;
  if (dev < 64) known[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

// The scratch of a call on n streams in comp_len bytes: ctl's int64 words
// (zero them), the summaries and their bytes each.
int snappy_cuda_segment_streams_scratch(int64_t comp_len, int64_t n, int64_t* ctl, int64_t* pool,
                                        int64_t* summary_bytes) {
  *ctl = ctl_words(comp_len, n);
  *pool = pool_for(comp_len, n);
  *summary_bytes = kSumWords * 16;
  return 0;
}

// Launch K4 over n streams on `stream`: as many blocks as the device holds
// at once (at most a stream and a summary each). Pointers as the header
// gives them; ctl zero, sums `pool` summaries. Returns the launch's
// cudaError_t; does not synchronise.
int snappy_cuda_segment_streams(const void* comp, int64_t comp_len, const void* starts, const void* clens,
                                const void* ulens, const void* out_starts, int64_t out_len, int64_t n,
                                int64_t capacity, void* rows_in, void* rows_out, void* rows_clen, void* rows_ulen,
                                void* rows_stream, void* stream_ok, void* ctl, void* sums, int64_t pool,
                                void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t err = prefer_shared();
  if (err != cudaSuccess) return err;
  int64_t blocks = resident();
  blocks = blocks < n + pool ? blocks : n + pool;
  blocks = blocks > 0 ? blocks : 1;
  const Rows rows{static_cast<int64_t*>(rows_in), static_cast<int64_t*>(rows_out),
                  static_cast<int32_t*>(rows_clen), static_cast<int32_t*>(rows_ulen),
                  static_cast<int32_t*>(rows_stream)};
  unsigned long long* words = static_cast<unsigned long long*>(ctl);
  const Work work{words + kStats, reinterpret_cast<Long*>(words + kCtlHead),
                  reinterpret_cast<uint32_t*>(words + kCtlHead + 4 * n), static_cast<uint4*>(sums), uint64_t(pool)};
  segment_streams_kernel<<<dim3(unsigned(blocks)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), comp_len, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(clens), static_cast<const int32_t*>(ulens),
      static_cast<const int64_t*>(out_starts), out_len, n, capacity, rows, static_cast<uint8_t*>(stream_ok), words,
      work);
  return cudaGetLastError();
}

// The shared memory a block of K4 takes, in bytes, and how many of its
// blocks one SM of the current device holds at once.
int snappy_cuda_segment_streams_occupancy(int* smem_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, segment_streams_kernel);
  if (err != cudaSuccess) return err;
  *smem_bytes = int(attr.sharedSizeBytes);
  err = prefer_shared();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, segment_streams_kernel, kThreads, 0);
}

}  // extern "C"
