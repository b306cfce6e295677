// The round-4 probe kernels P1-P6 for Hopper (sm_90a): the primitives that
// a decoder's tag walk and record drains are built from, one kernel each, so
// that their cost a step can be read on the card.
//
// Replaces the Pallas kernels of benchmarks/exp_vector_walk.py:
//   P1  build_chain: _chain_kernel (axis 0, 1), _alu_chain_kernel,
//       _multi_chain_kernel (gather, reduce)          -> chain_kernel
//   P2  build_walk8: _walk8_kernel                      -> walk8_kernel
//   P3  build_walk_scalar: _walk_scalar_kernel          -> walk_scalar_kernel
//   P4  build_drain: _drain8_kernel (gather, logroll),
//       _drain_serial_kernel                            -> drain8_kernel, drain_serial_kernel
//   P5  run_scalar_costs: _scalar_loop_kernel           -> scalar_loop_kernel
//   P6  run_when: _when_drain_kernel                    -> when_drain_kernel
// Each computes what its TPU kernel computes, bit for bit, with the rules
// and layouts of the plain versions in ops/probes_torch.py: int32 wraps,
// `>>` is arithmetic, a dynamic row or word index is clamped into its array,
// and output positions that no store reaches hold INT_MIN. The TPU's (8,128)
// vector registers and SMEM scalars become this card's: warps whose lanes
// hold the (8, 128) state's values, or one thread where the TPU ran its
// scalar core.
//
// What bounds them: P1, P2, P3 and P5 are chains of dependent steps (a
// select, a load, a tag), so their time is the latency of one step's
// critical path times the steps; P4 and P6 drain records that do not depend
// on each other, bound by a block's issue and its loads and stores. The
// bytes are a few KiB to a few MiB. The design keeps every step's operands
// on chip (registers, shared memory) so that the latency read is the
// primitive's own. When `cycles` is not null, thread 0 of block 0 writes the
// clock64() span of its block there: the slope of two knobs gives cycles a
// step without assuming a clock rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kIntMin = INT32_MIN;
constexpr int kRows = 320;                  // command rows of a walked block
constexpr int kNcp = kRows * kLanes;        // command words of a walked block
constexpr int kTiles = 96;                  // P2's record tiles a group
constexpr int kTile = 8 * kLanes;           // words of an (8, 128) tile
constexpr int kRecScratch = kTiles * kLanes;  // P3's record scratch
// P2's bursts of 4 steps a row: a walk whose every tag advances at least one
// position leaves a row of 128 within 128 steps, so the cap changes nothing
// for a walk that ends, and a tag of advance 0 ends the row at the cap.
constexpr int kMaxBursts = 32;
constexpr int kWhenRecords = 4096;
constexpr int kWhenSrcRows = 260;
constexpr int kWhenOutRows = 504;

enum ChainMode { kAxis0, kAxis1, kAlu, kGather, kReduce };
enum DrainMode { kDrainGather, kDrainLogroll, kDrainSerial };
enum WhenMode { kAlways, kWhen, kNone };

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int clamp_index(int32_t v, int last) {
  return v < 0 ? 0 : (v > last ? last : v);
}

__device__ __forceinline__ int32_t* shared_words() {
  extern __shared__ __align__(16) int32_t smem_words[];
  return smem_words;
}

// ------------------------------------------------------------------ P1
// What bounds it on this card: the latency of one step's dependent chain
// (ALU ops, a shared load or a shuffle), so long as no SM has more selects
// a step to serve than it serves in that time. One block of 8 warps, as
// the TPU's one core held the state, put 8 x 4G selects a step on one SM,
// and the gather's random words cost ~2.4 wavefronts each: the SM's shared
// memory, not the select, set the step (90 cycles at G=1, 4.2x that at 4,
// on an NVIDIA H100 80GB HBM3 at 700 W). So the state is spread over
// blocks and every block runs the same steps (block 0's clock64() span
// gives cycles a step). alu, axis 0, axis 1, gather: 32 one-warp blocks,
// each thread holding its G chains; lane 8 (c mod 4) + s of block c / 4
// holds column c, sublane s. A column's 8 sublanes are one 8-lane segment
// of a warp, so axis 1 is one shuffle of width 8 from lane x mod 8 of the
// segment (INT_MIN for an index >= 8), with no barrier. The gather reads
// its lane's own copy of its sublane's window row, word k at byte
// ((k << 5) + lane) * 4 (16 KiB a block): every load is one wavefront
// whatever the index, and the address is a shift and a mask of x. reduce:
// 8 blocks, one a sublane row, warp g of its G warps holding chain g (lane
// t the lanes t + 32j), a compare and a warp sum a step: one warp's warp
// sums do not overlap, the SM's warps' do. The ALU chain's step is
// idempotent after the first ((x & 127) ^ x clears the low bits), so an
// empty asm hides each step's input from the compiler, which would
// otherwise fold several steps into one.
constexpr int kColumnBlocks = kLanes / 4;

template <int kMode, int G>
__global__ void __launch_bounds__(kMode == kReduce ? G * kWarp : kWarp)
chain_kernel(int reps, const int32_t* __restrict__ x, int32_t* __restrict__ out,
             long long* __restrict__ cycles) {
  const int lane = threadIdx.x % kWarp;
  const long long start = clock64();
  if (kMode == kReduce) {
    const int s = blockIdx.x, row = (threadIdx.x / kWarp * 8 + s) * kLanes;
    int32_t v[4], win[4];
    for (int j = 0; j < 4; ++j) {
      v[j] = x[row + lane + kWarp * j];
      win[j] = x[s * kLanes + lane + kWarp * j];
    }
    for (int i = 0; i < reps; ++i) {
      unsigned part = 0;
      for (int j = 0; j < 4; ++j)
        part += (v[j] & 127) == lane + kWarp * j ? static_cast<uint32_t>(win[j]) : 0u;
      const int32_t w = static_cast<int32_t>(__reduce_add_sync(kFull, part));
      for (int j = 0; j < 4; ++j) v[j] = add32(add32(v[j], w & 7), 1);
    }
    for (int j = 0; j < 4; ++j) out[row + lane + kWarp * j] = v[j];
  } else {
    const int s = lane & 7, at = s * kLanes + blockIdx.x * 4 + (lane >> 3);
    const char* own = reinterpret_cast<const char*>(shared_words());  // gather: window row s, this lane's copy
    const uint32_t lane4 = lane * 4;
    int32_t v[G];
    for (int g = 0; g < G; ++g) v[g] = x[g * kTile + at];
    if (kMode == kGather) {
      for (int k = 0; k < kLanes; ++k) shared_words()[k * kWarp + lane] = x[s * kLanes + k];
      __syncwarp();
    }
    for (int i = 0; i < reps; ++i) {
      if (kMode == kAlu) {
        for (int g = 0; g < G; ++g) {
          asm volatile("" : "+r"(v[g]));
          v[g] = add32((v[g] & 127) ^ v[g], 1);
        }
      } else if (kMode == kAxis0) {
        int32_t nv[G];
        for (int g = 0; g < G; ++g) {
          const int idx = v[g] & 7;
          int32_t sel = kIntMin;
          for (int h = 0; h < G; ++h) sel = idx == h ? v[h] : sel;
          nv[g] = add32(sel, 1);
        }
        for (int g = 0; g < G; ++g) v[g] = nv[g];
      } else if (kMode == kAxis1) {
        for (int g = 0; g < G; ++g) {
          const int32_t sel = __shfl_sync(kFull, v[g], v[g], 8);  // sublane v mod 8 of this column
          v[g] = add32((v[g] & 127) < 8 ? sel : kIntMin, 1);
        }
      } else {
        for (int g = 0; g < G; ++g) {
          const uint32_t byte = (static_cast<uint32_t>(v[g]) << 7 & (127u << 7)) | lane4;
          v[g] = add32(add32(v[g], *reinterpret_cast<const int32_t*>(own + byte) & 7), 1);
        }
      }
    }
    for (int g = 0; g < G; ++g) out[g * kTile + at] = v[g];
  }
  if (cycles) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) *cycles = clock64() - start;
  }
}

// ------------------------------------------------------------------ copies
// Asynchronous copies from device memory into shared memory (cp.async): rows
// 16 bytes a piece, single words 4, in groups that
// a thread commits and later waits for, oldest first. A wait covers only the
// waiting thread's own copies, so a barrier follows it before any thread
// reads what landed. Off the card (the host emulation) a copy is a plain
// copy and a wait does nothing, unless the includer defines the three
// SNAPPY_HOST_ hooks (the emulation lands a group when its thread waits).
// The 32-bit address of a shared-memory word, as cp.async and st.shared take
// it (off the card: its byte offset into the block's shared words).
__device__ __forceinline__ uint32_t shared_addr(const int32_t* p) {
#ifdef __CUDA_ARCH__
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#else
  return static_cast<uint32_t>(reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(shared_words()));
#endif
}

#ifndef __CUDA_ARCH__
// The shared word at address `at` as a pointer, off the card.
__device__ __forceinline__ int32_t* host_word(uint32_t at) {
  return reinterpret_cast<int32_t*>(reinterpret_cast<char*>(shared_words()) + at);
}
#endif

#ifndef SNAPPY_HOST_COPY
#define SNAPPY_HOST_COPY(dst, src, n) \
  for (int i_ = 0; i_ < (n); ++i_) (dst)[i_] = (src)[i_]
#define SNAPPY_HOST_COMMIT()
#define SNAPPY_HOST_WAIT(n)
#endif

__device__ __forceinline__ void copy_async16(uint32_t dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src));
#else
  SNAPPY_HOST_COPY(host_word(dst), src, 4);
#endif
}

__device__ __forceinline__ void copy_async4(uint32_t dst, const int32_t* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
#else
  SNAPPY_HOST_COPY(host_word(dst), src, 1);
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
  SNAPPY_HOST_COMMIT();
#endif
}

// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#else
  SNAPPY_HOST_WAIT(N);
#endif
}

// Copy kWords words from `src`, 16-byte aligned (the wrappers in
// ops/cuda_probes.py see to it), to shared address `dst`, 16 bytes a piece,
// thread `tid` of kThreads taking every kThreads-th piece.
template <int kWords, int kThreads>
__device__ __forceinline__ void copy_words(uint32_t dst, const int32_t* src, int tid) {
  static_assert(kWords % (4 * kThreads) == 0, "a copy is whole 16-byte pieces, the same number a thread");
#pragma unroll
  for (int i = 0; i < kWords / (4 * kThreads); ++i)
    copy_async16(dst + (i * kThreads + tid) * 16, src + (i * kThreads + tid) * 4);
}

// Store v to the shared word at address `at` where a < b, unsigned: a
// predicated st.shared, never a branch around the store.
__device__ __forceinline__ void store_shared_below(uint32_t a, uint32_t b, uint32_t at, int32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile("{\n\t.reg .pred p;\n\tsetp.lt.u32 p, %0, %1;\n\t@p st.shared.b32 [%2], %3;\n\t}"
               :: "r"(a), "r"(b), "r"(at), "r"(v) : "memory");
#else
  if (a < b) *reinterpret_cast<int32_t*>(reinterpret_cast<char*>(shared_words()) + at) = v;
#endif
}

// Lane l's word of row `row` of out (out_l = out + l) gets v where a < b,
// unsigned: a store that every lane issues and only those lanes perform, the
// reference's masked store. No branch, so the compiler cannot sink the
// stored value's load behind one (a load inside a divergent branch waits out
// its whole latency before the store, record after record); the compare and
// the row's address are the asm's own, one instruction each.
__device__ __forceinline__ void store_below(uint32_t a, uint32_t b, int32_t* out_l, uint32_t row, int32_t v) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .b64 at;\n\tsetp.lt.u32 p, %0, %1;\n\t"
      "mad.wide.u32 at, %3, 512, %2;\n\t@p st.global.b32 [at], %4;\n\t}"
      :: "r"(a), "r"(b), "l"(out_l), "r"(row), "r"(v));
#else
  if (a < b) out_l[row * kLanes] = v;
#endif
}

// ------------------------------------------------------------------ P2
// One warp a group: lane l walks walk l mod 8, so each walk runs in 4 lanes
// that compute the same values from the same words (a load or an append of
// theirs is one address, served once), and no lane leaves the warp's path.
// What bounds it is one step's dependent chain: the command word's shared
// load, its decode and the next word's address. The step is branch-free:
// `act` (the walk's position d = ip - 128 r in [0, lim), in row r and below
// its length) is a mask that zeroes the advance, the append is a predicated
// st.shared, and the window load is unconditional. The next word's address
// is built apart from ip, mod 128 words: (address + 4 cx + (w >> 2)) & 0x1FC
// | the row's 512-byte-aligned base, four integer ops after the load, where
// w >> 2 stands for 4 ln (the bits it has beyond ln are multiples of 512 or
// below 4, which the mask drops). The exact position, op, the record and the
// next act are off that chain: the next step's word is loaded as soon as its
// address is known, before the rest of the step issues. The 8 appends of a
// step go to the record tile held position-major (word 8 pos + walk), so
// they fall in 8 banks whatever the cursors; a flush writes it back
// walk-major, the tile's layout in device memory. Rows of command words
// arrive in a ring of kWalkRows rows in shared memory by cp.async,
// kWalkRows - 1 rows ahead. Per row, bursts of 4 steps run while any walk is
// active, at most kMaxBursts; the vote that ends them is taken on the act of
// a burst's last step, which its third step gives, so it is off the chain (a
// burst it starts for nothing changes nothing: a walk whose position leaves
// the row stays out of it). After a row, a vote on any cursor at 96 flushes
// the tile. A group whose walks do not each have one length over their 128
// lanes is refused: meta (-1, -1), records all INT_MIN.
constexpr int kWalkRows = 4;

__global__ void __launch_bounds__(kWarp)
walk8_kernel(int nrow, const int32_t* __restrict__ clen, const int32_t* __restrict__ cmds,
             int32_t* __restrict__ rec, int32_t* __restrict__ meta, long long* __restrict__ cycles) {
  int32_t* rows_s = shared_words();            // [kWalkRows][8][128]
  int32_t* acc = rows_s + kWalkRows * kTile;   // [128 positions][8 walks]
  const char* smem = reinterpret_cast<const char*>(rows_s);
  const int grp = blockIdx.x, lane = threadIdx.x, walk = lane & 7;
  const long long start = clock64();
  const int32_t* cl = clen + int64_t(grp) * kTile;
  const int32_t* cg = cmds + int64_t(grp) * kRows * kTile;
  int32_t* rg = rec + int64_t(grp) * kTiles * kTile;

  bool same = true;  // every load independent of the last (no short cut)
#pragma unroll
  for (int m = 0; m < kTile / kWarp; ++m) same &= cl[m * kWarp + lane] == cl[m * kWarp & ~(kLanes - 1)];
  same = __all_sync(kFull, same);
  const int32_t my_clen = cl[walk * kLanes];
  for (int i = lane; i < kTile; i += kWarp) acc[i] = 0;
  const int rows = same ? nrow : 0;
  const uint32_t rows_at = shared_addr(rows_s), acc_at = rows_at + (kWalkRows * kTile + walk) * 4;
  int32_t ip = 0, op = 0, cur = 0;
  int tile = 0;
  for (int r = 0; r < kWalkRows - 1; ++r) {
    if (r < rows) copy_words<kTile, kWarp>(rows_at + r * kTile * 4, cg + int64_t(r) * kTile, lane);
    copy_commit();
  }
  for (int r = 0; r < rows; ++r) {
    copy_wait<kWalkRows - 2>();
    __syncwarp();  // row r has landed; every lane is done with row r - 1's slot
    const int ahead = r + kWalkRows - 1;
    if (ahead < rows)
      copy_words<kTile, kWarp>(rows_at + ahead % kWalkRows * kTile * 4, cg + int64_t(ahead) * kTile, lane);
    copy_commit();
    const uint32_t base = uint32_t(r % kWalkRows * kTile + walk * kLanes) * 4;  // 512-byte aligned
    const int32_t rbase = r * kLanes;
    // The walk is active while d = ip - rbase lies in [0, lim): in row r and
    // below its length.
    const int64_t room = int64_t(my_clen) - rbase;
    const uint32_t lim = room <= 0 ? 0u : room < kLanes ? uint32_t(room) : uint32_t(kLanes);
    int32_t d = ip - rbase;
    uint32_t at = base | (uint32_t(ip) << 2 & 0x1FC);
    bool act = uint32_t(d) < lim;
    // Two masks: from one (w & mask), nvcc derives the literal bit by a
    // shift, a mask and a compare on the chain; from its own, one LOP3 sets
    // a predicate.
    int32_t m7 = act ? 7 : 0, m8 = act ? 8 : 0;
    bool more = __any_sync(kFull, act);
    int32_t w = *reinterpret_cast<const int32_t*>(smem + at);
    for (int b = 0; more && b < kMaxBursts; ++b) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int32_t cx = w & m7;
        const bool lit = (w & m8) != 0;  // a literal, and act
        at = (at + uint32_t(cx) * 4 + (lit ? uint32_t(w >> 2) : 0u)) & 0x1FC | base;
        // The next step's word is loaded at once; the rest of this step
        // issues while it is in flight (one past the row's end is read and
        // dropped).
        const int32_t next = *reinterpret_cast<const int32_t*>(smem + at);
        const int32_t ln = (w >> 4) & 0x7F;
        store_shared_below(uint32_t(cur), act ? kLanes : 0u, acc_at + uint32_t(cur) * 32,
                           (rbase + d) | (static_cast<int32_t>(uint32_t(w) << 28) & kIntMin));
        cur += act;
        op = add32(op, act ? ln : 0);
        d += cx + (lit ? ln : 0);
        act = uint32_t(d) < lim;
        m7 = act ? 7 : 0;
        m8 = act ? 8 : 0;
        if (k == 2) more = __any_sync(kFull, act);
        w = next;
      }
    }
    ip = rbase + d;
    if (__any_sync(kFull, cur >= 96)) {
      __syncwarp();
      // word m * 32 + lane of the tile: position 4 m + lane / 8 of walk lane % 8
      int32_t* dst = rg + (tile < kTiles - 1 ? tile : kTiles - 1) * kTile + walk * kLanes + lane / 8;
#pragma unroll 8
      for (int m = 0; m < kTile / kWarp; ++m) {
        dst[4 * m] = acc[m * kWarp + lane];
        acc[m * kWarp + lane] = 0;
      }
      __syncwarp();
      cur = 0;
      ++tile;
    }
  }
  __syncwarp();
  const int last = tile < kTiles - 1 ? tile : kTiles - 1;
  int32_t* dst = rg + last * kTile + walk * kLanes + lane / 8;
#pragma unroll 8
  for (int m = 0; m < kTile / kWarp; ++m) dst[4 * m] = same ? acc[m * kWarp + lane] : kIntMin;
  for (int i = (last + 1) * kTile + lane; i < kTiles * kTile; i += kWarp) rg[i] = kIntMin;
  const int32_t max_op = __reduce_max_sync(kFull, op);
  const int32_t max_cur = __reduce_max_sync(kFull, cur);
  if (lane == 0) {
    meta[2 * grp] = same ? max_op : -1;
    meta[2 * grp + 1] = same ? max_cur : -1;
    if (cycles && grp == 0) *cycles = clock64() - start;
  }
}

// ------------------------------------------------------------------ P3
// One thread block a block of commands: its threads stage the 160 KiB of
// command words in shared memory, then thread 0 walks, unrolled by 16, as
// the TPU's scalar core did. The record of every step goes to a 48 KiB
// scratch in shared memory through a volatile pointer, so the compiler keeps
// the stores that the reference makes and nothing reads.
constexpr int kWalkThreads = 256;
constexpr int64_t kWalkSmem = int64_t(kNcp + kRecScratch) * 4;

__global__ void __launch_bounds__(kWalkThreads)
walk_scalar_kernel(int64_t rounds, const int32_t* __restrict__ clen, const int32_t* __restrict__ cmds,
                   int32_t* __restrict__ meta, long long* __restrict__ cycles) {
  int32_t* words = shared_words();
  volatile int32_t* recs = words + kNcp;
  const int blk = blockIdx.x, tid = threadIdx.x;
  const long long start = clock64();
  const int32_t* src = cmds + int64_t(blk) * kNcp;
  for (int i = tid; i < kNcp; i += kWalkThreads) words[i] = src[i];
  __syncthreads();
  if (tid == 0) {
    const int32_t cl = clen[blk];
    int32_t ip = 0, op = 0, t = 0;
    for (int64_t i = 0; i < rounds; ++i) {
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int32_t w = words[clamp_index(ip, kNcp - 1)];
        const int32_t cx = w & 7, lit = (w >> 3) & 1, ln = (w >> 4) & 0x7F;
        const int32_t live = ip < cl ? 1 : 0;
        recs[t < kRecScratch - 1 ? t : kRecScratch - 1] = lit ? (ip | kIntMin) : ip;
        ip = add32(ip, live * (cx + lit * ln));
        op = add32(op, live * ln);
        t = add32(t, live);
      }
    }
    meta[2 * blk] = op;
    meta[2 * blk + 1] = t;
    if (cycles && blk == 0) *cycles = clock64() - start;
  }
}

// ------------------------------------------------------------------ P4
// One block, as a decode block drains its own records. Records do not
// depend on each other; only each output lane's stores must stay in record
// order, so that a later record to a row wins. What bounds a one-block drain
// is what one SM takes in (512 bytes of source row and, for drain8, 512 of
// fields a record) and issues, not a chain; a load waited for before each
// group, two block barriers a group and stores behind a divergent branch
// left 265-420 cycles a record (NVIDIA H100 80GB HBM3, 700 W). Here every
// load arrives through a ring of kDrainStages batch stages in shared memory,
// a batch two groups of 8 records, filled by cp.async kDrainStages - 1
// batches ahead; q0 and r ride a ring of their own kDrainStages - 1 batches
// further ahead, so a source row's address is in shared memory when its copy
// is issued. One barrier a batch hands a stage on and frees the one before
// it. Stores are predicated st.global (store_below), never a branch, and
// each output lane's are issued by one thread in record order. Rows are
// clamped into their arrays by DPX: q0 (and q0 + 1, q0 + 2) into the source,
// r (and r + 1) into the output, each sum wrapping as the reference's int32
// arithmetic does.
//
// drain8 (8 warps): between two barriers warp k computes two records, k of
// each group of the batch, as two independent chains, 4 lanes a thread
// (gather through the staged row; logroll as 7 stages of shuffles, each a
// rotate right by 2**b where the lane's shift has bit b), and writes (z +
// ph, the clamped row or kNoRow where the lane keeps nothing) into one of
// two slots; threads 0-127, one output lane each, store the previous batch's
// 16 records from the other slot while the warps compute this one. serial (4
// warps): one thread a lane computes and stores every record itself, with
// lane 0's fields: the merge at ph is one shared load from the staged row q0
// or q0 + 1, its second store's the word 128 later; 8 threads copy each
// record's three rows, one q0 load each.
// tools/drain_parts.py builds copies with SNAPPY_DRAIN_STORES=0 (no
// stores) or also SNAPPY_DRAIN_COMPUTE=0 (no drain8 compute) to time what is
// left; their outputs are wrong.
#ifndef SNAPPY_DRAIN_STORES
#define SNAPPY_DRAIN_STORES 1
#endif
#ifndef SNAPPY_DRAIN_COMPUTE
#define SNAPPY_DRAIN_COMPUTE 1
#endif
constexpr int kDrainStages = 6;                // D: batches in flight
constexpr int kBatch = 16;                     // records a batch: two groups of 8
constexpr int kQrSlots = 2 * kDrainStages;     // batches of q0 and r held
constexpr int kQrWords = 2 * kBatch;           // a batch's 16 q0, then its 16 r
constexpr uint32_t kNoRow = 0xFFFFFFFFu;
constexpr int kDrain8Threads = 8 * kWarp;
constexpr int kDrain8Stage = 2 * kBatch * kLanes;      // 16 field rows, then 16 source rows
constexpr int kSerialStage = 3 * kBatch * kLanes + kBatch;  // 16 x 3 source rows, then 16 lane-0 fields
constexpr int64_t kDrain8Smem =
    (int64_t(kDrainStages) * kDrain8Stage + 2 * 2 * kBatch * kLanes + kQrSlots * kQrWords) * 4;
constexpr int64_t kSerialSmem = (int64_t(kDrainStages) * kSerialStage + kQrSlots * kQrWords) * 4;

// q0 and r of the first `batches` batches into their slots, by plain loads:
// the ring's first fill, before the copies that need their q0. Only records
// below nvalid are read.
__device__ __forceinline__ void qr_fill(int32_t* qr, const int32_t* q0, const int32_t* r, int batches, int nvalid,
                                        int tid, int nthreads) {
  for (int i = tid; i < batches * kQrWords; i += nthreads) {
    const int b = i / kQrWords, k = i % kQrWords, rc = b * kBatch + k % kBatch;
    if (rc < nvalid) qr[b % kQrSlots * kQrWords + k] = k < kBatch ? q0[rc] : r[rc];
  }
}

// q0 and r of batch h into its slot of the ring at shared address qr_at, by
// threads 0-31; only records below nvalid.
__device__ __forceinline__ void qr_copy(uint32_t qr_at, const int32_t* q0, const int32_t* r, int h, int nvalid,
                                        int tid) {
  const int rc = h * kBatch + tid % kBatch;
  if (tid < kQrWords && rc < nvalid)
    copy_async4(qr_at + (h % kQrSlots * kQrWords + tid) * 4, tid < kBatch ? q0 + rc : r + rc);
}

template <int kMode>
__global__ void __launch_bounds__(kDrain8Threads)
drain8_kernel(int nrec, int nsrc, const int32_t* __restrict__ q0, const int32_t* __restrict__ r,
              const int32_t* __restrict__ fld, const int32_t* __restrict__ src, int32_t* __restrict__ out,
              long long* __restrict__ cycles) {
  int32_t* stages = shared_words();
  int2* zs = reinterpret_cast<int2*>(stages + kDrainStages * kDrain8Stage);  // [2][16][128]
  int32_t* qr = stages + kDrainStages * kDrain8Stage + 2 * 2 * kBatch * kLanes;
  const int tid = threadIdx.x, k = tid / kWarp, t = tid % kWarp;
  const int last_src = nsrc - 1, last_out = nsrc + 7, groups = nrec / 8, nvalid = groups * 8;
  const int batches = (groups + 1) / 2;
  const uint32_t stages_at = shared_addr(stages), qr_at = shared_addr(qr);
  const long long start = clock64();
  for (int i = tid; i < (nsrc + 8) * kLanes; i += kDrain8Threads) out[i] = kIntMin;
  qr_fill(qr, q0, r, batches < kDrainStages - 1 ? batches : kDrainStages - 1, nvalid, tid, kDrain8Threads);
  __syncthreads();
  // Batch h's 16 field rows and the 16 source rows its q0 name (warp k copies
  // records k and 8 + k's) into stage h mod D; q0 and r of batch h + D - 1.
  auto issue = [&](int h) {
    const uint32_t st = stages_at + h % kDrainStages * kDrain8Stage * 4;
    const int32_t* qs = qr + h % kQrSlots * kQrWords;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int g = 2 * h + half;
      if (g < groups) {
        copy_words<kTile, kDrain8Threads>(st + half * kTile * 4, fld + int64_t(g) * kTile, tid);
        const int32_t* row = src + int64_t(__vimin_s32_relu(qs[8 * half + k], last_src)) * kLanes;
        copy_words<kLanes, kWarp>(st + (kBatch + 8 * half + k) * kLanes * 4, row, t);
      }
    }
    if (h + kDrainStages - 1 < batches) qr_copy(qr_at, q0, r, h + kDrainStages - 1, nvalid, tid);
    copy_commit();
  };
  for (int h = 0; h < kDrainStages - 1; ++h) issue(h);
  int32_t* out_l = out + tid;
  for (int b = 0; b <= batches; ++b) {
    copy_wait<kDrainStages - 2>();
    __syncthreads();  // batch b has landed; batch b - 1 is computed, b - 2 stored
    issue(b + kDrainStages - 1);
    if (SNAPPY_DRAIN_STORES && b > 0 && tid < kLanes) {
      const int2* z = zs + (b - 1) % 2 * kBatch * kLanes + tid;
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const int2 v = z[kk * kLanes];
        store_below(uint32_t(v.y), kNoRow, out_l, uint32_t(v.y), v.x);
      }
    }
    if (SNAPPY_DRAIN_COMPUTE && b < batches) {  // records k and 8 + k of the batch, two chains at once
      // Thread t's lanes: t + 32 i for the gather (a shift shared by the
      // lanes then reads 32 consecutive words, one bank each), 4t + i for
      // the logroll (a rotate by 4m is then one shuffle from thread t - m).
      auto lane_of = [&](int i) { return kMode == kDrainGather ? t + kWarp * i : 4 * t + i; };
      const int32_t* st = stages + b % kDrainStages * kDrain8Stage;
      const int32_t* qs = qr + b % kQrSlots * kQrWords;
      int32_t z[2][4], fv[2][4];
      uint32_t orow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rk = 8 * h + k;
        orow[h] = 2 * b + h < groups ? __vimin_s32_relu(qs[kBatch + rk], last_out) : kNoRow;
        const int32_t* f = st + rk * kLanes;
        const int32_t* row = st + (kBatch + rk) * kLanes;
        if (kMode == kDrainGather) {
          for (int i = 0; i < 4; ++i) fv[h][i] = f[lane_of(i)];
          for (int i = 0; i < 4; ++i) z[h][i] = row[(lane_of(i) + fv[h][i]) & 127];
        } else {
          const int4 f4 = reinterpret_cast<const int4*>(f)[t], z4 = reinterpret_cast<const int4*>(row)[t];
          fv[h][0] = f4.x, fv[h][1] = f4.y, fv[h][2] = f4.z, fv[h][3] = f4.w;
          z[h][0] = z4.x, z[h][1] = z4.y, z[h][2] = z4.z, z[h][3] = z4.w;
        }
      }
      if (kMode == kDrainLogroll) {
        // Stage b rotates right by s = 2**b where the lane's shift has bit b:
        // lane 4t + i takes lane 4t + i - s, which for s = 4m is word i of
        // thread t - m (mod 32, the wrap included) and for s = 1, 2 a word of
        // this thread or the one before.
#pragma unroll
        for (int bit = 0; bit < 7; ++bit) {
          const int s = 1 << bit;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int32_t rolled[4];
            if (s < 4) {
              for (int i = 0; i < 4; ++i)
                rolled[i] = i >= s ? z[h][i - s] : __shfl_sync(kFull, z[h][4 + i - s], (t - 1) & (kWarp - 1));
            } else {
              for (int i = 0; i < 4; ++i) rolled[i] = __shfl_sync(kFull, z[h][i], (t - s / 4) & (kWarp - 1));
            }
            for (int i = 0; i < 4; ++i) z[h][i] = (fv[h][i] >> bit) & 1 ? rolled[i] : z[h][i];
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int32_t v[4], rows[4];
        for (int i = 0; i < 4; ++i) {
          const int32_t f = fv[h][i], ph = (f >> 7) & 127, lo = (f >> 14) & 127, n = (f >> 21) & 0x7F;
          v[i] = add32(z[h][i], ph);
          rows[i] = static_cast<int32_t>(uint32_t(lane_of(i) - lo) < uint32_t(n) ? orow[h] : kNoRow);
        }
        int2* zo = zs + b % 2 * kBatch * kLanes + (8 * h + k) * kLanes;
        if (kMode == kDrainGather) {
          for (int i = 0; i < 4; ++i) zo[lane_of(i)] = int2{v[i], rows[i]};
        } else {
          int4* zo4 = reinterpret_cast<int4*>(zo + 4 * t);
          zo4[0] = int4{v[0], rows[0], v[1], rows[1]};
          zo4[1] = int4{v[2], rows[2], v[3], rows[3]};
        }
      }
    }
  }
  __syncthreads();
  if (cycles && tid == 0) *cycles = clock64() - start;
}

__global__ void __launch_bounds__(kLanes)
drain_serial_kernel(int nrec, int nsrc, const int32_t* __restrict__ q0, const int32_t* __restrict__ r,
                    const int32_t* __restrict__ fld, const int32_t* __restrict__ src, int32_t* __restrict__ out,
                    long long* __restrict__ cycles) {
  int32_t* stages = shared_words();
  int32_t* qr = stages + kDrainStages * kSerialStage;
  const int l = threadIdx.x;
  const int last_src = nsrc - 1, last_out = nsrc + 7;
  const int nvalid = (nrec + 7) / 8 * 8, batches = (nrec + kBatch - 1) / kBatch;  // read whole groups
  const uint32_t stages_at = shared_addr(stages), qr_at = shared_addr(qr);
  const long long start = clock64();
  for (int i = l; i < (nsrc + 8) * kLanes; i += kLanes) out[i] = kIntMin;
  qr_fill(qr, q0, r, batches < kDrainStages - 1 ? batches : kDrainStages - 1, nvalid, l, kLanes);
  __syncthreads();
  // Batch h's 48 source rows (q0, q0 + 1, q0 + 2 of each record; 8 threads
  // a record, thread l copying part l mod 8 of its record's rows) and lane
  // 0's field of each record into stage h mod D; q0 and r of batch h + D - 1.
  auto issue = [&](int h) {
    const int rk = l / 8, rc = h * kBatch + rk;
    const uint32_t st = stages_at + h % kDrainStages * kSerialStage * 4;
    if (rc < nvalid) {
      const int32_t q = qr[h % kQrSlots * kQrWords + rk];
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
        copy_words<kLanes, 8>(st + (rk * 3 + kk) * kLanes * 4,
                              src + int64_t(__vimin_s32_relu(add32(q, kk), last_src)) * kLanes, l % 8);
    }
    if (l >= kLanes - kBatch && h * kBatch + l - (kLanes - kBatch) < nvalid)
      copy_async4(st + (3 * kBatch * kLanes + l - (kLanes - kBatch)) * 4,
                  fld + (int64_t(h) * kBatch + l - (kLanes - kBatch)) * kLanes);
    if (h + kDrainStages - 1 < batches) qr_copy(qr_at, q0, r, h + kDrainStages - 1, nvalid, l);
    copy_commit();
  };
  for (int h = 0; h < kDrainStages - 1; ++h) issue(h);
  int32_t* out_l = out + l;
  for (int b = 0; b < batches; ++b) {
    copy_wait<kDrainStages - 2>();
    __syncthreads();  // batch b has landed; batch b - 1 is stored
    issue(b + kDrainStages - 1);
    const int32_t* st = stages + b % kDrainStages * kSerialStage;
    const int32_t* qs = qr + b % kQrSlots * kQrWords;
#pragma unroll
    for (int kk = 0; kk < kBatch; ++kk) {
      const int32_t f = st[3 * kBatch * kLanes + kk];
      const int32_t shift = f & 127, ph = (f >> 7) & 127, lo = (f >> 14) & 127;
      const int32_t n = b * kBatch + kk < nrec ? (f >> 21) & 0x7F : 0;
      const int j = (l - shift) & 127;
      const int32_t* at = st + kk * 3 * kLanes + (j >= ph ? 0 : kLanes) + j;  // row q0 where j >= ph, else q0 + 1
      const int32_t rr = qs[kBatch + kk];
      if (SNAPPY_DRAIN_STORES) {
        store_below(uint32_t(l - lo), uint32_t(n), out_l, __vimin_s32_relu(rr, last_out), at[0]);
        store_below(uint32_t(l + kLanes - lo), uint32_t(n), out_l, __viaddmin_s32_relu(rr, 1, last_out), at[kLanes]);
      }
    }
  }
  __syncthreads();
  if (cycles && l == 0) *cycles = clock64() - start;
}

// ------------------------------------------------------------------ P5
// One thread, as the TPU's scalar core: x in shared memory, the variant's
// work, unroll, cond and chain fixed at compile time.
template <int kWork, int kUnroll, bool kCond, bool kChain>
__global__ void __launch_bounds__(kWarp)
scalar_loop_kernel(int n, const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   long long* __restrict__ cycles) {
  int32_t* xs = shared_words();
  const long long start = clock64();
  for (int i = threadIdx.x; i < 1024; i += kWarp) xs[i] = x[i];
  __syncwarp();
  if (threadIdx.x == 0) {
    int32_t ip = 0, acc = 0;
    while (ip < n) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kChain) {
          const int32_t v1 = xs[ip & 1023];
          const int32_t v2 = xs[add32(ip, v1) & 1023];
          acc = add32(acc, xs[add32(ip, v2) & 1023]);
        }
#pragma unroll
        for (int w = 0; w < kWork; ++w) acc = add32(acc ^ (acc >> 1), 1);
        if (kCond) acc = add32(acc, (acc & 1) == 0 ? 2 : 3);
        ip = add32(ip, 1);
      }
    }
    out[0] = acc;
    if (cycles) *cycles = clock64() - start;
  }
}

// ------------------------------------------------------------------ P6
// One block of 128 threads, one lane each, as a decode block drains its own
// records; src, q and r staged in shared memory (the reference's VMEM and
// SMEM). Records do not depend on each other: only a lane's stores must
// stay in record order, so that a later record to a row wins. So what
// bounds it on this card is the block's issue and the latency its one warp
// a scheduler cannot hide, not a chain. Each record's stores behind a
// branch, with its loads sunk into the branch, took 52-73 cycles a record
// (NVIDIA H100 80GB HBM3, 700 W). Here the stores are predicated, never
// branched around, and the drain is software-pipelined by a group: group
// g + 1's 8 q and 8 r (four 16-byte loads) and src words are read while
// group g stores. A record's merge at lo is one load, from q's row where
// j >= lo and the next row else, so a lane reads one word a store; the
// rows are clamped by one DPX instruction each. The second store is issued
// under each lane's mask (always), behind a branch on the record's lo + n
// that every thread takes alike (when), or not at all (none).
constexpr int64_t kWhenSmem = int64_t(kWhenSrcRows * kLanes + 2 * kWhenRecords) * 4;
constexpr int kWhenGroups = kWhenRecords / 8;  // groups of a pass over the records

// One record's loads and masks, ahead of its stores.
struct WhenRecord {
  int32_t v1, v2;          // the merge for row r and for row r + 1
  uint32_t d, d2, n;       // lane - lo and lane + 128 - lo, below n where stored
  uint32_t row1, row2;     // r and r + 1, clamped
  bool cross;              // lo + n > 128
};

template <int kMode>
__device__ __forceinline__ WhenRecord when_load(const int32_t* ssrc, int l, int32_t q, int32_t rr) {
  WhenRecord w{};
  const int32_t lo = q & 127, n = (q >> 7) & 63, d = l - lo;
  const int j = d & 127;
  const int32_t* at = ssrc + (q & 255) * kLanes + j;  // q's row, word j
  const int o = j >= lo ? 0 : kLanes;                 // the merge at lo: q's row, else the next
  w.v1 = at[o];
  w.d = d;
  w.n = n;
  w.row1 = __vimin_s32_relu(rr, kWhenOutRows - 1);
  w.cross = lo + n > kLanes;
  if (kMode != kNone) {
    w.v2 = at[kLanes - o];
    w.d2 = d + kLanes;  // below n where l < lo + n - 128
    w.row2 = __viaddmin_s32_relu(rr, 1, kWhenOutRows - 1);
  }
  return w;
}

template <int kMode>
__device__ __forceinline__ void when_store(int32_t* out_l, const WhenRecord& w) {
  store_below(w.d, w.n, out_l, w.row1, w.v1);
  if (kMode == kAlways || (kMode == kWhen && w.cross)) store_below(w.d2, w.n, out_l, w.row2, w.v2);
}

template <int kMode>
__global__ void __launch_bounds__(kLanes)
when_drain_kernel(int ngroups, const int32_t* __restrict__ q, const int32_t* __restrict__ r,
                  const int32_t* __restrict__ src, int32_t* __restrict__ out, long long* __restrict__ cycles) {
  int32_t* ssrc = shared_words();
  int32_t* sq = ssrc + kWhenSrcRows * kLanes;
  int32_t* sr = sq + kWhenRecords;
  const int l = threadIdx.x;
  const long long start = clock64();
  for (int i = l; i < kWhenOutRows * kLanes; i += kLanes) out[i] = kIntMin;
  for (int i = l; i < kWhenSrcRows * kLanes; i += kLanes) ssrc[i] = src[i];
  for (int i = l; i < kWhenRecords; i += kLanes) {
    sq[i] = q[i];
    sr[i] = r[i];
  }
  __syncthreads();
  const int4* q4 = reinterpret_cast<const int4*>(sq);
  const int4* r4 = reinterpret_cast<const int4*>(sr);
  int32_t* out_l = out + l;
  // Software-pipelined by a group: group g + 1's q, r and src words are read
  // while group g stores.
  WhenRecord cur[8];
  auto load_group = [&](int g, WhenRecord* recs) {
    const int t = g % kWhenGroups * 2;
    const int4 qa = q4[t], qb = q4[t + 1], ra = r4[t], rb = r4[t + 1];
    const int32_t qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const int32_t rs[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) recs[k] = when_load<kMode>(ssrc, l, qs[k], rs[k]);
  };
  load_group(0, cur);
  for (int g = 0; g < ngroups; ++g) {
    WhenRecord next[8];
    load_group(g + 1, next);
#pragma unroll
    for (int k = 0; k < 8; ++k) when_store<kMode>(out_l, cur[k]);
#pragma unroll
    for (int k = 0; k < 8; ++k) cur[k] = next[k];
  }
  __syncthreads();
  if (cycles && l == 0) *cycles = clock64() - start;
}

// ------------------------------------------------------------------ one-block read
// Not a port of a TPU kernel: the rate at which one SM takes words in from
// L2, which bounds a one-block drain. One block of kDrain8Threads threads
// streams `tiles` tiles of 16 KiB of x into shared memory through a ring as
// the drains' (kReadStages tiles, cp.async, one barrier a tile) and XORs
// every word, so that each is read; out[0] is the XOR of x. Bytes over the
// clock64() span of two sizes give bytes a cycle.
constexpr int kReadStages = 6;
constexpr int kReadTile = 4 * kTile;  // words

__global__ void __launch_bounds__(kDrain8Threads)
l2_read_kernel(int tiles, const int32_t* __restrict__ x, int32_t* __restrict__ out, long long* __restrict__ cycles) {
  int32_t* ring = shared_words();
  uint32_t* part = reinterpret_cast<uint32_t*>(ring + kReadStages * kReadTile);  // a word a warp
  const int tid = threadIdx.x;
  const uint32_t ring_at = shared_addr(ring);
  const long long start = clock64();
  auto issue = [&](int h) {
    if (h < tiles)
      copy_words<kReadTile, kDrain8Threads>(ring_at + h % kReadStages * kReadTile * 4, x + int64_t(h) * kReadTile,
                                            tid);
    copy_commit();
  };
  for (int h = 0; h < kReadStages - 1; ++h) issue(h);
  uint32_t acc = 0;
  for (int g = 0; g < tiles; ++g) {
    copy_wait<kReadStages - 2>();
    __syncthreads();
    issue(g + kReadStages - 1);
    const int4* tile = reinterpret_cast<const int4*>(ring + g % kReadStages * kReadTile);
#pragma unroll
    for (int m = 0; m < kReadTile / 4 / kDrain8Threads; ++m) {
      const int4 v = tile[m * kDrain8Threads + tid];
      acc ^= uint32_t(v.x) ^ uint32_t(v.y) ^ uint32_t(v.z) ^ uint32_t(v.w);
    }
  }
  acc = __reduce_xor_sync(kFull, acc);
  if (tid % kWarp == 0) part[tid / kWarp] = acc;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kDrain8Threads / kWarp; ++w) acc ^= part[w];
    out[0] = static_cast<int32_t>(acc);
    if (cycles) *cycles = clock64() - start;
  }
}

// ------------------------------------------------------------------ dispatch
// The instantiation a mode names (null for none), and each probe's launch
// shape: blocks, threads a block and dynamic shared memory.
using ChainKernel = void (*)(int, const int32_t*, int32_t*, long long*);
using DrainKernel = void (*)(int, int, const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                             int32_t*, long long*);
using ScalarKernel = void (*)(int, const int32_t*, int32_t*, long long*);
using WhenKernel = void (*)(int, const int32_t*, const int32_t*, const int32_t*, int32_t*, long long*);

struct Shape {
  int blocks, threads;
  int64_t smem;
};

template <int G>
ChainKernel chain_for_g(int mode) {
  switch (mode) {
    case kAxis0: return chain_kernel<kAxis0, G>;
    case kAxis1: return chain_kernel<kAxis1, G>;
    case kAlu: return chain_kernel<kAlu, G>;
    case kGather: return chain_kernel<kGather, G>;
    case kReduce: return chain_kernel<kReduce, G>;
    default: return nullptr;
  }
}

ChainKernel chain_for(int mode, int g) {
  return g == 1 ? chain_for_g<1>(mode) : g == 4 ? chain_for_g<4>(mode) : nullptr;
}

Shape chain_shape(int mode, int g) {
  if (mode == kReduce) return {8, g * kWarp, 0};
  return {kColumnBlocks, kWarp, mode == kGather ? int64_t(kLanes) * kWarp * 4 : 0};
}

Shape walk8_shape(int groups) { return {groups, kWarp, int64_t(kWalkRows + 1) * kTile * 4}; }

Shape walk_scalar_shape(int blocks) { return {blocks, kWalkThreads, kWalkSmem}; }

DrainKernel drain_for(int mode) {
  switch (mode) {
    case kDrainGather: return drain8_kernel<kDrainGather>;
    case kDrainLogroll: return drain8_kernel<kDrainLogroll>;
    case kDrainSerial: return drain_serial_kernel;
    default: return nullptr;
  }
}

Shape drain_shape(int mode) {
  const bool serial = mode == kDrainSerial;
  return {1, serial ? kLanes : kDrain8Threads, serial ? kSerialSmem : kDrain8Smem};
}

ScalarKernel scalar_loop_for(int work, int unroll, int cond, int chain) {
  const int key = work * 1000 + unroll * 100 + (cond ? 10 : 0) + (chain ? 1 : 0);
  switch (key) {
    case 4100: return scalar_loop_kernel<4, 1, false, false>;
    case 4800: return scalar_loop_kernel<4, 8, false, false>;
    case 16100: return scalar_loop_kernel<16, 1, false, false>;
    case 16800: return scalar_loop_kernel<16, 8, false, false>;
    case 4110: return scalar_loop_kernel<4, 1, true, false>;
    case 4810: return scalar_loop_kernel<4, 8, true, false>;
    case 4801: return scalar_loop_kernel<4, 8, false, true>;
    case 4101: return scalar_loop_kernel<4, 1, false, true>;
    default: return nullptr;
  }
}

Shape scalar_loop_shape() { return {1, kWarp, int64_t(1024) * 4}; }

WhenKernel when_for(int mode) {
  switch (mode) {
    case kAlways: return when_drain_kernel<kAlways>;
    case kWhen: return when_drain_kernel<kWhen>;
    case kNone: return when_drain_kernel<kNone>;
    default: return nullptr;
  }
}

Shape when_shape() { return {1, kLanes, kWhenSmem}; }

Shape l2_read_shape() { return {1, kDrain8Threads, (int64_t(kReadStages) * kReadTile + kWarp) * 4}; }

}  // namespace

// ------------------------------------------------------------------ launch

namespace {

template <class Kernel, class... Args>
int launch(Kernel kernel, Shape shape, void* stream, Args... args) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (shape.blocks <= 0) return cudaSuccess;
  if (shape.smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shape.smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(unsigned(shape.blocks)), dim3(unsigned(shape.threads)), size_t(shape.smem),
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches one probe on `stream` and returns the
// cudaError_t of the launch (0 on success); none synchronises. `cycles` is a
// long long on the card, or null.

int snappy_probe_chain(int mode, int g, int reps, const void* x, void* out, void* cycles, void* stream) {
  return launch(chain_for(mode, g), chain_shape(mode, g), stream, reps, static_cast<const int32_t*>(x),
                static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_walk8(int groups, int nrow, const void* clen, const void* cmds, void* rec, void* meta,
                       void* cycles, void* stream) {
  return launch(walk8_kernel, walk8_shape(groups), stream, nrow, static_cast<const int32_t*>(clen),
                static_cast<const int32_t*>(cmds), static_cast<int32_t*>(rec), static_cast<int32_t*>(meta),
                static_cast<long long*>(cycles));
}

int snappy_probe_walk_scalar(int blocks, int64_t rounds, const void* clen, const void* cmds, void* meta,
                             void* cycles, void* stream) {
  return launch(walk_scalar_kernel, walk_scalar_shape(blocks), stream, rounds, static_cast<const int32_t*>(clen),
                static_cast<const int32_t*>(cmds), static_cast<int32_t*>(meta), static_cast<long long*>(cycles));
}

int snappy_probe_drain(int mode, int nrec, int nsrc, const void* q0, const void* r, const void* fld,
                       const void* src, void* out, void* cycles, void* stream) {
  return launch(drain_for(mode), drain_shape(mode), stream, nrec, nsrc, static_cast<const int32_t*>(q0),
                static_cast<const int32_t*>(r), static_cast<const int32_t*>(fld), static_cast<const int32_t*>(src),
                static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_scalar_loop(int work, int unroll, int cond, int chain, int n, const void* x, void* out,
                             void* cycles, void* stream) {
  return launch(scalar_loop_for(work, unroll, cond, chain), scalar_loop_shape(), stream, n,
                static_cast<const int32_t*>(x), static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_when_drain(int mode, int ngroups, const void* q, const void* r, const void* src, void* out,
                            void* cycles, void* stream) {
  return launch(when_for(mode), when_shape(), stream, ngroups, static_cast<const int32_t*>(q),
                static_cast<const int32_t*>(r), static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
                static_cast<long long*>(cycles));
}

// The one-block read of `tiles` tiles of 4096 words of x (not a probe).
int snappy_probe_l2_read(int tiles, const void* x, void* out, void* cycles, void* stream) {
  return launch(l2_read_kernel, l2_read_shape(), stream, tiles, static_cast<const int32_t*>(x),
                static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

}  // extern "C"
