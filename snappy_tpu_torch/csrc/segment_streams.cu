// Segmenter of raw Snappy streams for Hopper (sm_90a), kernel K4: one warp a
// stream, walked 32 tags at a time, cuts each stream into the rows that K1's
// ragged variant (decode_blocks.cu) decodes in one launch.
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
//        the table holds)
//   out: the rows: in i64, out i64 (absolute offsets into comp and out),
//        clen i32, ulen i32, stream i32; stream_ok u8[n]; stats i64[4], zero
//        on entry: rows reserved, rows that hold segments, boundaries merged
//        away, streams taken whole.
// Stream s reserves ceil(ulen / 64 KiB) rows (no segment but the last holds
// less than 64 KiB of output) with one atomic add on stats[0]; the rows it
// does not fill are empty (clen = ulen = 0), which K1 decodes to nothing. A
// stream whose rows would pass `capacity` is not ok.
//
// What bounds it on the card: the serial chain of tag positions of the
// longest stream (a tag's position depends on the previous tag's length),
// ~116,000 tags for a 610 KB l_comment page, without K1's moves. A chase
// that parses each tag in turn took ~150 cycles a tag there (8.8 ms a row
// group against K1's 10.0); this design takes ~52 (3.0 ms a page, 3.7 ms a
// row group), of which the four-tag steps' dependent shared loads ~25, the
// batch's tag reads and checks ~14, the tables ~9, the staging ~1. It takes
// the parsing off the chain:
// - the stream passes through a ring of kRing bytes, staged with 16-byte
//   loads from the 16-byte chunk that holds the next tag;
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
//   walks it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// Compressed bytes a block stages at a time (a build may set it): with its
// three tables, 8 KiB a block, so that 25 blocks share an SM and a row
// group's ~2,700 streams run in one wave on 132 SMs.
#ifndef SNAPPY_K4_RING
#define SNAPPY_K4_RING 2048
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 64;  // two warps: both stage and chart the ring, the first walks it
constexpr uint32_t kRing = SNAPPY_K4_RING;
constexpr uint32_t kPad = 4;                 // bytes a tag's trailer may read past it
constexpr uint32_t kBlock = 1u << 16;        // a segment closes at a tag at or past this output
constexpr uint32_t kMaxSegment = 1u << 17;   // the most output a segment may hold
constexpr uint32_t kMaxOffset = 0x1ffff;     // the largest copy offset a segmented stream may hold
constexpr uint64_t kMaxLiteral = 0x1fff8;    // the longest literal a segmented stream may hold
constexpr int kSegmented = 0, kWhole = -1, kCorrupt = -2;
constexpr uint32_t kStop = 0xFF;  // a table entry no step crosses (a step is at most 4 x 61 bytes)
constexpr uint32_t kFull = 0xFFFFFFFFu;
static_assert(kRing % 16 == 0 && kRing >= 64, "the ring holds whole 16-byte chunks, 64 bytes or more");

// The rows K4 writes.
struct Rows {
  int64_t* in;
  int64_t* out;
  int32_t* clen;
  int32_t* ulen;
  int32_t* stream;
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

// The ring := src bytes [base, end): from `at` rounded down to 16, kRing of
// them or up to in_end, those at or past `have` as zeros. All threads call
// it, between two block barriers.
__device__ __forceinline__ void stage(uint8_t* ring, const uint8_t* __restrict__ src, uint32_t at,
                                      uint32_t in_end, uint32_t have, bool wide, int tid, uint32_t& base,
                                      uint32_t& end) {
  base = at & ~15u;
  end = lesser(base + kRing, in_end);
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

__device__ __forceinline__ void chart(const uint8_t* ring, const uint8_t* advance, uint8_t* step1, uint8_t* step2,
                                      uint8_t* step4, uint32_t base, uint32_t end, uint32_t n, int tid) {
  const uint32_t len = end - base;
  for (uint32_t i0 = tid; i0 < len; i0 += kUnroll * kThreads) {
    uint32_t d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads;
      d[u] = i < len ? advance[ring[i]] : kStop;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t i = i0 + u * kThreads, q = base + i;
      if (i < len) step1[i] = uint8_t(q + 1 < n && q + 5 <= end && q + d[u] <= end ? d[u] : kStop);
    }
  }
  __syncthreads();
  double_steps(step1, step2, len, tid);
  __syncthreads();
  double_steps(step2, step4, len, tid);
  __syncthreads();
}

// The tag byte at t and the 4 bytes after it (little-endian).
__device__ __forceinline__ void read_tag(const uint8_t* t, uint32_t& c, uint32_t& word) {
  c = t[0];
  word = uint32_t(t[1]) | uint32_t(t[2]) << 8 | uint32_t(t[3]) << 16 | uint32_t(t[4]) << 24;
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

__global__ void __launch_bounds__(kThreads)
segment_streams_kernel(const uint8_t* __restrict__ comp, int64_t comp_len, const int64_t* __restrict__ starts,
                       const int32_t* __restrict__ clens, const int32_t* __restrict__ ulens,
                       const int64_t* __restrict__ out_starts, int64_t out_len, int64_t capacity, const Rows rows,
                       uint8_t* __restrict__ stream_ok, unsigned long long* stats) {
  __shared__ __align__(16) uint8_t ring[kRing];
  __shared__ uint8_t step1[kRing];
  __shared__ uint8_t step2[kRing];
  __shared__ uint8_t step4[kRing];
  __shared__ uint8_t advance[256];
  __shared__ unsigned long long reserved;
  __shared__ uint32_t next_stage;  // the first warp's position to stage from, or ~0u when it is done
  const int64_t stream = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  for (uint32_t c = tid; c < 256; c += kThreads) {
    const uint32_t entry = tag_entry(c);
    advance[c] = uint8_t(c & 3u ? 1 + (entry >> 11) : (entry >> 11) == 0 ? 1 + (entry & 0xFF) : kStop);
  }
  const int64_t start = starts[stream], clen = clens[stream], ulen = ulens[stream], out0 = out_starts[stream];

  // The stream and its output lie in their buffers.
  bool ok = start >= 0 && clen >= 0 && start <= comp_len - clen && ulen >= 0 && out0 >= 0 &&
            out0 <= out_len - ulen;
  // The varint header: at most 5 bytes, the fifth below 0x10, equal to the
  // stated length.
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
  // The rows this stream may fill.
  Scan s;
  s.cap = ok ? uint32_t((ulen + kBlock - 1) >> 16) : 0u;
  if (tid == 0) reserved = s.cap ? atomicAdd(&stats[0], (unsigned long long)s.cap) : 0ull;
  __syncthreads();
  s.base = int64_t(reserved);
  const int64_t room = capacity - s.base;
  s.owned = room <= 0 ? 0u : room < int64_t(s.cap) ? uint32_t(room) : s.cap;
  ok = ok && s.owned == s.cap;

  // The scan, in ring coordinates: the body's first byte sits `shift` bytes
  // into its 16-byte chunk where comp is aligned.
  int status = ok ? kSegmented : kCorrupt;
  const int64_t body = start + hdr;
  const bool wide = (reinterpret_cast<uintptr_t>(comp) & 15) == 0;
  s.shift = ok && wide ? uint32_t(body & 15) : 0u;
  s.n = ok ? uint32_t(clen - hdr) + s.shift : 0u;
  s.ulen = ok ? uint32_t(ulen) : 0u;
  const uint8_t* src = comp + (ok ? body - s.shift : 0);
  const uint32_t in_end = s.n + kPad;
  const int64_t have64 = ok ? comp_len - (body - s.shift) : 0;
  const uint32_t have = uint32_t(have64 < int64_t(in_end) ? have64 : int64_t(in_end));
  uint32_t ip = s.shift, rbase = 0, rend = 0;  // the ring holds [rbase, rend)
  for (;;) {
    // Both warps stage and chart the ring from where the first warp stands;
    // the first walks it as far as it holds whole tags.
    if (tid == 0) next_stage = status == kSegmented && ip + 1 < s.n ? ip : ~0u;
    __syncthreads();
    const uint32_t from = next_stage;
    if (from == ~0u) break;
    stage(ring, src, from, in_end, have, wide, tid, rbase, rend);
    __syncthreads();
    chart(ring, advance, step1, step2, step4, rbase, rend, s.n, tid);
    if (tid >= kWarp) continue;
    while (status == kSegmented && ip + 1 < s.n && ip + 5 <= rend) {
      // The chase: up to 32 tags, four at a time while the table allows, then
      // one at a time, the k-th kept by lane k.
      uint32_t nb = 0, next_ip = ip, at4 = 0;
      for (; nb + 4 <= uint32_t(kWarp) && next_ip < rend; nb += 4) {
        const uint32_t d = step4[next_ip - rbase];
        if (d == kStop) break;
        if (lane == int(nb >> 2)) at4 = next_ip;
        next_ip += d;
      }
      uint32_t at = __shfl_sync(kFull, at4, lane >> 2);
      if (uint32_t(lane) < nb) {
        if (lane & 2) at += step2[at - rbase];
        if (lane & 1) at += step1[at - rbase];
      }
      for (; nb < uint32_t(kWarp) && next_ip < rend; ++nb) {
        const uint32_t d = step1[next_ip - rbase];
        if (d == kStop) break;
        if (lane == int(nb)) at = next_ip;
        next_ip += d;
      }
      if (nb == 0) {
        // One tag alone: a literal with a length trailer or past the ring.
        uint32_t c, word;
        read_tag(ring + (ip - rbase), c, word);
        status = scan_step(s, rows, ip, c, word, ip, lane);
        continue;
      }
      // Each lane reads its tag; a warp sum gives the batch's output.
      const bool mine = uint32_t(lane) < nb;
      uint32_t c = 0, word = 0;
      if (mine) read_tag(ring + (at - rbase), c, word);
      const uint32_t entry = tag_entry(c);
      const uint32_t taglen = entry >> 11;
      const uint32_t tag_end = at + 1 + taglen;
      const bool lit = (c & 3u) == 0;
      const uint32_t len = mine ? entry & 0xFF : 0;
      const uint32_t f = (entry & 0x700) + (taglen ? word & (0xFFFFFFFFu >> (32 - 8 * taglen)) : 0);
      const uint32_t total = __reduce_add_sync(kFull, len);
      // Whatever the fast path might not take, judged against the batch's
      // start (`into` bytes of output into its segment; a tag's own output
      // position is at least that far in): a segment mark, a copy that may
      // reach behind the segment's start or the output's, more output than
      // stated, a tag or literal past the stream, a limit.
      const uint32_t into = s.op - s.seg_start;
      bool event =
          s.blk == 0 || into + total >= kBlock || total > s.ulen - s.op ||
          __ballot_sync(kFull, mine && (tag_end > s.n || (lit ? len > s.n - tag_end
                                                              : f == 0 || f > into || f > kMaxOffset)));
      if (event) {
        // The same, exactly: each tag at its own output position (a warp
        // scan).
        uint32_t end = len;
#pragma unroll
        for (int d = 1; d < kWarp; d <<= 1) {
          const uint32_t v = __shfl_up_sync(kFull, end, d);
          if (lane >= d) end += v;
        }
        const uint32_t pos = s.op + end - len;
        event = s.blk == 0 ||
                __ballot_sync(kFull, mine && (tag_end > s.n || pos > s.ulen || len > s.ulen - pos ||
                                              pos - s.seg_start >= kBlock || pos + len - s.seg_start > kMaxSegment ||
                                              (lit ? len > s.n - tag_end
                                                   : f == 0 || f > pos || pos - f < s.seg_start || f > kMaxOffset)));
      }
      if (!event) {
        s.op += total;
        ip = next_ip;
        continue;
      }
      // The scan's own rule, tag by tag.
      for (uint32_t k = 0; k < nb && status == kSegmented; ++k) {
        const uint32_t tag_at = __shfl_sync(kFull, at, k);
        const uint32_t tag_c = __shfl_sync(kFull, c, k);
        const uint32_t tag_word = __shfl_sync(kFull, word, k);
        status = scan_step(s, rows, tag_at, tag_c, tag_word, ip, lane);
      }
    }
  }
  if (tid >= kWarp) return;
  if (status == kSegmented && s.op != s.ulen) status = kCorrupt;
  __syncwarp();

  // The rows: the segments (closed here), the whole stream, or none; the
  // rest of the reservation empty.
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
    const uint32_t k = k0 + lane;
    const int64_t r = s.base + k;
    int64_t in_rel = 0, next = 0, out_rel = 0;
    if (k < used) {
      in_rel = rows.in[r];
      next = k + 1 < used ? rows.in[r + 1] : int64_t(body_n);
      out_rel = rows.out[r];
    }
    __syncwarp();
    if (k < used) {
      rows.in[r] = body + in_rel;
      rows.out[r] = out0 + out_rel;
      rows.clen[r] = int32_t(next - in_rel);
    } else if (k < s.owned) {
      rows.in[r] = 0;
      rows.out[r] = 0;
      rows.clen[r] = 0;
      rows.ulen[r] = 0;
    }
    if (k < s.owned) rows.stream[r] = int32_t(stream);
    __syncwarp();
  }
  if (lane == 0) {
    stream_ok[stream] = status != kCorrupt;
    if (used) atomicAdd(&stats[1], (unsigned long long)used);
    if (status == kSegmented && s.merged) atomicAdd(&stats[2], (unsigned long long)s.merged);
    if (status == kWhole) atomicAdd(&stats[3], 1ull);
  }
}

}  // namespace

extern "C" {

// 25 blocks of 8 KiB an SM need the largest shared-memory carveout. The
// preference belongs to the current device; it is set once on each (on
// devices past the 64th, at every call).
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

// Launch K4 over n streams on `stream` (pointers as the header gives them;
// stats zero). Returns the launch's cudaError_t; does not synchronise.
int snappy_cuda_segment_streams(const void* comp, int64_t comp_len, const void* starts, const void* clens,
                                const void* ulens, const void* out_starts, int64_t out_len, int64_t n,
                                int64_t capacity, void* rows_in, void* rows_out, void* rows_clen, void* rows_ulen,
                                void* rows_stream, void* stream_ok, void* stats, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t err = prefer_shared();
  if (err != cudaSuccess) return err;
  const Rows rows{static_cast<int64_t*>(rows_in), static_cast<int64_t*>(rows_out),
                  static_cast<int32_t*>(rows_clen), static_cast<int32_t*>(rows_ulen),
                  static_cast<int32_t*>(rows_stream)};
  segment_streams_kernel<<<dim3(unsigned(n)), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), comp_len, static_cast<const int64_t*>(starts),
      static_cast<const int32_t*>(clens), static_cast<const int32_t*>(ulens),
      static_cast<const int64_t*>(out_starts), out_len, capacity, rows, static_cast<uint8_t*>(stream_ok),
      static_cast<unsigned long long*>(stats));
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
