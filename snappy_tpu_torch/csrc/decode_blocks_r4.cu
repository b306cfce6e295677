// Snappy block decoder for Hopper (sm_90a) after the pinned round-4 design:
// a walk into record chunks, then drains. One thread block per headerless
// tag stream; one warp walks while the others drain the chunk before.
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
// What bounds it on the card: the walk, a serial chain of dependent loads
// (each tag's position depends on the one before), one chain per stream.
// The bytes moved are few (each output byte written once, each literal or
// copied byte read once). The design keeps that chain short and alone on
// the critical path, and several streams on an SM:
//   walk     warp 0 chases up to 32 tag positions at a time (all lanes
//            alike, lane j keeping the j-th) through a table of advances:
//            for each byte of a 512-byte window of the row, the bytes from a
//            tag there to the next tag (0 where the walk must stop), filled by
//            the warp's 32 lanes in parallel from aligned 4-byte loads and
//            funnel shifts, anew whenever the walk leaves the window. K3's
//            parse_cmds prepass (pallas_decode_r4.py:126) computes such
//            command words for every position; here only the window's. The
//            chain is then a shared load, a test and a 32-bit add a tag. Then
//            each lane decodes its own tag: a warp scan gives the output
//            positions, ballots the record slots and the checks, and each
//            tag becomes one 16-byte record (source or offset, op, n, and for
//            a copy whether it reads at or past its group's first output
//            position) in one of two chunks of kChunk records: literals from
//            the chunk's front, copies from its back. A warp OR sets the
//            chunk's bit for each group of kGroup copies that holds such a
//            copy. (K3's prepass also folds a 64-byte COPY_2 and the copy of
//            the same offset after it into one record, pallas_decode_r4.py:
//            212-251, to save drain steps; a record a lane saves nothing
//            here, so none fold.)
//   drains   the other warps drain the chunk the walker filled before, while
//            it fills the other one: a named barrier a chunk each way hands the
//            chunks over. Literals go in any order (their source is the row,
//            which is never written); then the copies in ordered groups: all
//            drain warps move the records that read only bytes before the
//            group's first output position, and a group with the walker's bit
//            then takes a second barrier and one warp moves the rest in order.
//            A copy moves out[op + j] = out[op - f + (j mod f)], which reads
//            only bytes before op, so overlapping (RLE) copies need no chain.
//   memory   the output row is staged in shared memory where two blocks still
//            fit an SM (three at 64 KiB: 1024 streams in about three waves on
//            132 SMs); a wider row goes to device memory and is drained there.
//            The compressed row is read through L1, prefetched into L2 by the
//            drain warps at the start.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SNAPPY_R4_THREADS
#define SNAPPY_R4_THREADS 256
#endif

namespace {

constexpr int kCompPad = 4;
constexpr uint32_t kThreads = SNAPPY_R4_THREADS;
constexpr uint32_t kWarp = 32;
constexpr uint32_t kDrainWarps = kThreads / kWarp - 1;
constexpr uint32_t kDrainThreads = kThreads - kWarp;
constexpr uint32_t kChunk = 256;  // records a chunk (K3's CHUNK is 1024)
constexpr uint32_t kGroup = 16;   // copies an ordered drain group, as K3's GROUP
constexpr uint32_t kMaxOffset = 0xFFFF;
constexpr uint32_t kMaxLiteral = 0x10000;
// Blocks an SM that shared memory allows at 64 KiB rows: registers may be
// spent up to that.
constexpr uint32_t kMinBlocks = 3;
// Named barriers (0 is __syncthreads): chunk b walked, chunk b drained, and
// the drain warps among themselves.
constexpr uint32_t kFullBar = 1;
constexpr uint32_t kEmptyBar = 3;
constexpr uint32_t kDrainBar = 5;
// A chunk's status bits.
constexpr uint32_t kOk = 1;
constexpr uint32_t kDone = 2;
static_assert(kThreads % kWarp == 0 && kDrainWarps >= 1, "a walker warp and whole drain warps");
static_assert(kChunk % kGroup == 0 && kChunk / kGroup <= 32, "a chunk's group bits fit 32 bits");
static_assert(kChunk % kWarp == 0, "a chunk holds whole steps of 32 tags");

// One chunk: its head (literal records, copy records, the group bits,
// status), then literal records from the front and copy records from the
// back. A record is (source or offset, op, n, reads at or past its group's
// first output position).
struct Chunk {
  uint4 head;
  uint4 rec[kChunk];
};
// Bytes of the row whose advances (the bytes from a tag at that position to
// the next tag) the walker tabulates at a time; the table has one more entry,
// 0, that stands for every position past the window.
constexpr uint32_t kWindow = 512;
// Shared memory: the two chunks, the walk's result (op, ok), the advances,
// the staged row.
constexpr int64_t kHeadBytes = 2 * sizeof(Chunk) + 16 + 4 * (kWindow + 4);
static_assert(kHeadBytes % 16 == 0, "the staged row stays 16-byte aligned");

__host__ __device__ __forceinline__ int64_t round16(int64_t n) { return (n + 15) & ~int64_t(15); }

// Barriers, a prefetch and a shared load in PTX, one line each.
__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t n) { asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(uint32_t id, uint32_t n) { asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }
// Shared memory by 32-bit address, for the walker's chase.
__device__ __forceinline__ uint32_t shared_addr(const void* p) { return uint32_t(__cvta_generic_to_shared(p)); }
__device__ __forceinline__ uint32_t lds(uint32_t a) { uint32_t v; asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory"); return v; }

// One past the last source byte a copy reads: out[op - f + (j mod f)] for
// j < n reads [op - f, op - f + min(n, f)).
__device__ __forceinline__ uint32_t copy_reach(uint32_t op, uint32_t f, uint32_t n) {
  return op - f + (n < f ? n : f);
}

// The tag at byte q of `words` (w0, w1 its aligned words): its trailer
// size tl, its length n, and for a literal its length - 1 m1 (n is 1 for a
// literal over kMaxLiteral, which is corrupt), for a copy its offset f.
struct Tag {
  uint32_t type, tl, m1, n, f;
};
__device__ __forceinline__ Tag parse(uint32_t w0, uint32_t w1, uint32_t q) {
  const uint32_t sh = (q & 3u) * 8;
  const uint32_t c = __funnelshift_r(w0, w1, sh) & 0xFFu;
  const uint32_t trail = __funnelshift_rc(w0, w1, sh + 8);
  const uint32_t type = c & 3u, hi6 = c >> 2;
  // tl trailer bytes: a literal's length - 1 (none below 60), a copy's
  // offset (its high bits in a COPY_1's tag).
  const uint32_t tl = type == 0 ? (hi6 < 60 ? 0u : hi6 - 59) : (0x4210u >> (4 * type)) & 0xFu;
  const uint32_t v = trail & (0xFFFFFFFFu >> ((32 - 8 * tl) & 31));
  const uint32_t m1 = tl == 0 ? hi6 : v;
  const uint32_t n = type == 0 ? (m1 < kMaxLiteral ? m1 + 1 : 1u) : type == 1 ? 4 + (hi6 & 7u) : hi6 + 1;
  return Tag{type, tl, m1, n, type == 1 ? v | ((c & 0xE0u) << 3) : v};
}

// The advance from each position of the window at ws of the row, by the
// lanes of the walker warp: 1 + the trailer + a literal's bytes; 0 where the
// walk stops there: at or past clen, a literal over kMaxLiteral, a tag that
// ends past clen (the last two corrupt).
__device__ void tabulate(const uint32_t* words, uint32_t off, uint32_t ws, uint32_t clen, uint32_t* adv,
                         uint32_t lane) {
  __syncwarp();
#pragma unroll 4
  for (uint32_t j = lane; j < kWindow; j += kWarp) {
    const uint32_t p = ws + j, q = (p < clen ? p : clen - 1) + off;
    const Tag t = parse(__ldg(words + (q >> 2)), __ldg(words + (q >> 2) + 1), q);
    const uint32_t a = 1 + t.tl + (t.type == 0 ? t.n : 0u);
    adv[j] = p >= clen || (t.type == 0 && t.m1 >= kMaxLiteral) || a > clen - p ? 0u : a;
  }
  __syncwarp();
}

// Walk the stream by warp 0 into the chunks, in turns, until it ends or is
// corrupt; leaves (op, ok) in result. ok enters as whether the row's lengths
// fit the batch (clen is then 0). Each step chases up to 32 tag positions
// through the advances of the window (tabulated anew when the walk leaves
// it), all lanes alike, lane j keeping the j-th; then every lane decodes its
// own tag, a warp scan gives the output positions, ballots the record slots
// and the checks, and a warp OR the group bits.
__device__ void walk(const uint8_t* src, uint32_t clen, uint32_t ulen, bool ok, Chunk* chunks,
                     uint32_t* result, uint32_t* adv, uint32_t lane) {
  // The row through aligned words: byte ip is byte (ip + off) of `words`.
  // A word read holds a byte of the row at or before clen + 3, which the row
  // has (C >= clen + 4), so no read leaves the row's aligned words.
  const uint32_t off = uint32_t(reinterpret_cast<uintptr_t>(src)) & 3u;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src - off);
  const uint32_t before = (1u << lane) - 1;  // the lanes before this one
  uint32_t ip = 0, op = 0, lead = 0, ws = 0u - kWindow;
  bool done = false;
  adv[kWindow] = 0;
  const uint32_t adv_s = shared_addr(adv);
  for (uint32_t k = 0;; ++k) {
    const uint32_t b = k & 1;
    Chunk& ch = chunks[b];
    if (k >= 2) bar_sync(kEmptyBar + b, kThreads);
    uint32_t nl = 0, nc = 0, flags = 0;
    while (ok && !done && nl + nc < kChunk) {
      // The chase: a shared load, a test and an add a tag, lane n keeping
      // the n-th position. A 0 past the window tabulates it anew at ip; a 0
      // then stops the walk: at the end, or corrupt.
      uint32_t mine = 0, n = 0;
      for (;;) {
        uint32_t a = 0;
        for (; n < kWarp; ++n) {
          const uint32_t idx = ip - ws;
          a = lds(adv_s + 4 * (idx < kWindow ? idx : kWindow));
          if (a == 0) break;
          mine = lane == n ? ip : mine;
          ip += a;
        }
        if (a == 0 && ip - ws >= kWindow && ip < clen) {
          ws = ip;
          tabulate(words, off, ws, clen, adv, lane);
          continue;
        }
        if (a == 0) {
          done = ip >= clen;
          ok = done;
        }
        break;
      }
      if (!ok) break;
      // Each lane's tag: its output position and the checks that need it.
      const bool has = lane < n;
      const uint32_t qm = mine + off;
      const Tag t = parse(__ldg(words + (qm >> 2)), __ldg(words + (qm >> 2) + 1), qm);
      const bool lit = t.type == 0;
      const uint32_t len = has ? t.n : 0u;
      uint32_t incl = len;
#pragma unroll
      for (uint32_t d = 1; d < kWarp; d <<= 1) {
        const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        incl += lane >= d ? x : 0u;
      }
      const uint32_t at = op + incl - len;
      op += __shfl_sync(0xFFFFFFFFu, incl, kWarp - 1);
      // A copy offset of 0, above 0xFFFF or beyond the output so far (f - 1
      // wraps for 0); output past ulen.
      const bool bad = has && (at + len > ulen || (!lit && t.f - 1 >= (at < kMaxOffset ? at : kMaxOffset)));
      if (__any_sync(0xFFFFFFFFu, bad)) {
        ok = false;
        break;
      }
      // Record slots, and each copy's group: a copy whose rank in the chunk
      // is a multiple of kGroup leads one; the others take the last lead at
      // or before them, here or carried from the step before.
      const uint32_t lits = __ballot_sync(0xFFFFFFFFu, has && lit);
      const uint32_t copies = __ballot_sync(0xFFFFFFFFu, has && !lit);
      const uint32_t rank = lit ? nl + __popc(lits & before) : nc + __popc(copies & before);
      const uint32_t leads = __ballot_sync(0xFFFFFFFFu, has && !lit && rank % kGroup == 0);
      const uint32_t mine_or_before = leads & (before | (1u << lane));
      const uint32_t lead_op = __shfl_sync(0xFFFFFFFFu, at, mine_or_before ? 31 - __clz(mine_or_before) : 0);
      const uint32_t my_lead = mine_or_before ? lead_op : lead;
      lead = __shfl_sync(0xFFFFFFFFu, my_lead, kWarp - 1);
      const uint32_t after = has && !lit && copy_reach(at, t.f, len) > my_lead;
      flags |= __reduce_or_sync(0xFFFFFFFFu, after << (rank / kGroup));
      if (has) ch.rec[lit ? rank : kChunk - 1 - rank] = make_uint4(lit ? mine + 1 + t.tl : t.f, at, len, after);
      nl += __popc(lits);
      nc += __popc(copies);
    }
    ch.head = make_uint4(nl, nc, flags, (ok ? kOk : 0u) | (done ? kDone : 0u));
    __threadfence_block();
    bar_arrive(kFullBar + b, kThreads);
    if (done || !ok) {
      // The drain warps' hand-back of the chunk before this one, unread yet.
      if (k >= 1) bar_sync(kEmptyBar + (b ^ 1), kThreads);
      result[0] = op;
      result[1] = ok;
      return;
    }
  }
}

// A literal's bytes, from the row, by the lanes of one warp: whole 4-byte
// words of the destination, each from two aligned words of the row and a
// funnel shift; the bytes before the first such word and after the last one
// alone. The second word of each pair starts at most one byte past the
// literal, which ends at least 4 bytes before the row does.
__device__ __forceinline__ void move_literal(uint8_t* dst, const uint8_t* __restrict__ src, uint32_t n,
                                             uint32_t lane) {
  const uint32_t head = (4u - uint32_t(reinterpret_cast<uintptr_t>(dst) & 3u)) & 3u;
  const uint32_t lead = head < n ? head : n;
  if (lane < lead) dst[lane] = __ldg(src + lane);
  const uint32_t rest = n - lead, so = uint32_t(reinterpret_cast<uintptr_t>(src + lead) & 3u);
  const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src + lead - so);
  uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + lead);
#pragma unroll 4
  for (uint32_t i = lane; i < rest / 4; i += kWarp) d4[i] = __funnelshift_r(__ldg(s4 + i), __ldg(s4 + i + 1), 8 * so);
  for (uint32_t j = (rest & ~3u) + lane; j < rest; j += kWarp) dst[lead + j] = __ldg(src + lead + j);
}

// A copy's bytes by the lanes of one warp.
__device__ __forceinline__ void move_copy(uint8_t* dst, uint32_t op, uint32_t f, uint32_t n, uint32_t lane) {
  const uint32_t base = op - f;
  for (uint32_t j = lane; j < n; j += kWarp) dst[op + j] = dst[base + (f >= n ? j : j % f)];
}

// Drain the chunks in turns by the warps after warp 0 (drain warp dw).
__device__ void drain(const uint8_t* __restrict__ src, uint8_t* dst, const Chunk* chunks, uint32_t dw,
                      uint32_t lane) {
  for (uint32_t k = 0;; ++k) {
    const uint32_t b = k & 1;
    const Chunk& ch = chunks[b];
    bar_sync(kFullBar + b, kThreads);
    const uint4 h = ch.head;
    if (h.w & kOk) {
      for (uint32_t t = dw; t < h.x; t += kDrainWarps) {
        const uint4 r = ch.rec[t];
        move_literal(dst + r.y, src + r.x, r.z, lane);
      }
      bar_sync(kDrainBar, kDrainThreads);
      for (uint32_t g = 0; g < h.y; g += kGroup) {
        const uint32_t end = g + kGroup < h.y ? g + kGroup : h.y;
        const bool flagged = (h.z >> (g / kGroup)) & 1u;
        for (uint32_t i = g + dw; i < end; i += kDrainWarps) {
          const uint4 r = ch.rec[kChunk - 1 - i];
          if (!r.w) move_copy(dst, r.y, r.x, r.z, lane);
        }
        if (flagged) {
          bar_sync(kDrainBar, kDrainThreads);
          if (dw == 0) {
            for (uint32_t i = g; i < end; ++i) {
              const uint4 r = ch.rec[kChunk - 1 - i];
              if (!r.w) continue;
              move_copy(dst, r.y, r.x, r.z, lane);
              // Later copies of the group may read these bytes.
              __syncwarp();
            }
          }
        }
        bar_sync(kDrainBar, kDrainThreads);
      }
    }
    if ((h.w & kDone) || !(h.w & kOk)) return;
    __threadfence_block();
    bar_arrive(kEmptyBar + b, kThreads);
  }
}

template <bool kStageOut>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_blocks_r4_kernel(const uint8_t* __restrict__ comp, const int32_t* __restrict__ clens,
                        const int32_t* __restrict__ ulens, int64_t row_c, int64_t out_size,
                        uint8_t* out, uint8_t* __restrict__ ok_out,
                        int32_t* __restrict__ total_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  Chunk* chunks = reinterpret_cast<Chunk*>(smem);
  uint32_t* result = reinterpret_cast<uint32_t*>(smem + 2 * sizeof(Chunk));
  uint32_t* adv = result + 4;
  uint8_t* out_s = smem + kHeadBytes;

  const int64_t row = blockIdx.x;
  const uint32_t tid = threadIdx.x;
  const uint32_t warp = tid / kWarp;
  const uint32_t lane = tid % kWarp;
  const uint8_t* src = comp + row * row_c;
  uint8_t* dst_g = out + row * out_size;

  const int64_t clen64 = clens[row];
  const int64_t ulen64 = ulens[row];
  // The wrapper does not read the lengths (that would wait for the stream):
  // a row whose lengths do not fit decodes nothing and comes back not ok and
  // all zero, reading or writing nothing outside its own row.
  const bool fits = clen64 >= 0 && clen64 <= row_c - kCompPad && ulen64 >= 0 && ulen64 <= out_size;
  const uint32_t clen = fits ? uint32_t(clen64) : 0;
  const uint32_t ulen = fits ? uint32_t(ulen64) : 0;
  uint8_t* dst = kStageOut ? out_s : dst_g;

  if (warp == 0) {
    walk(src, clen, ulen, fits, chunks, result, adv, lane);
  } else {
    for (uint32_t i = (tid - kWarp) * 128; i < clen; i += kDrainThreads * 128) prefetch_l2(src + i);
    drain(src, dst, chunks, warp - 1, lane);
  }
  __syncthreads();

  const uint32_t op = result[0];
  const bool ok = result[1] != 0 && op == ulen;
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

using KernelFn = void (*)(const uint8_t*, const int32_t*, const int32_t*, int64_t, int64_t, uint8_t*,
                          uint8_t*, int32_t*);

// The variant for rows of out_size bytes and its shared memory a block: the
// output staged where two blocks still fit an SM, else in device memory (a
// long unsegmentable raw stream). Three staged blocks of 64 KiB share an SM
// only with the largest shared-memory carveout, which is set here.
static cudaError_t pick(int64_t out_size, KernelFn* kernel, int64_t* smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0, per_sm = 0, reserved = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const int64_t staged = kHeadBytes + round16(out_size);
  if (staged <= optin && 2 * (staged + reserved) <= per_sm) {
    *kernel = decode_blocks_r4_kernel<true>;
    *smem = staged;
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               int(cudaSharedmemCarveoutMaxShared));
  } else {
    *kernel = decode_blocks_r4_kernel<false>;
    *smem = kHeadBytes;
  }
  if (err == cudaSuccess) err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem));
  return err;
}

// Launch the decoder over B rows on `stream`. Returns the cudaError_t of the
// launch (0 on success); does not synchronise.
int snappy_cuda_decode_blocks_r4(const void* comp, const void* clens, const void* ulens,
                                 int64_t rows, int64_t row_c, int64_t out_size, void* out,
                                 void* ok, void* total, void* stream) {
  if (rows <= 0) return cudaSuccess;
  KernelFn kernel;
  int64_t smem;
  cudaError_t err = pick(out_size, &kernel, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(rows)), kThreads, size_t(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(clens),
      static_cast<const int32_t*>(ulens), row_c, out_size, static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(total));
  return cudaGetLastError();
}

// The shared memory a block of the decoder takes for rows of out_size bytes,
// and how many of its blocks one SM of the current device holds at once.
int snappy_cuda_decode_blocks_r4_occupancy(int64_t out_size, int* smem_bytes, int* blocks_per_sm) {
  KernelFn kernel;
  int64_t smem;
  cudaError_t err = pick(out_size, &kernel, &smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = int(smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, size_t(smem));
}

}  // extern "C"
