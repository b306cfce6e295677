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

// ------------------------------------------------------------------ P2
// One warp a group: lanes 0-7 are the group's 8 walks (the others vote with
// them and walk nothing). A row of 8 x 128 command words is staged in shared
// memory while the next row's loads are in flight in registers; the record
// tile (8 x 128) lives in shared memory. Per row, bursts of 4 steps run while
// any walk's ip lies in the row (a warp vote), at most kMaxBursts; after the
// row, a vote on any cursor at 96 flushes the tile. A group whose walks do
// not each have one length over their 128 lanes is refused: meta (-1, -1),
// records all INT_MIN.
__global__ void __launch_bounds__(kWarp)
walk8_kernel(int nrow, const int32_t* __restrict__ clen, const int32_t* __restrict__ cmds,
             int32_t* __restrict__ rec, int32_t* __restrict__ meta, long long* __restrict__ cycles) {
  int32_t* row_s = shared_words();
  int32_t* acc = row_s + kTile;
  const int grp = blockIdx.x, lane = threadIdx.x;
  const long long start = clock64();
  const int32_t* cl = clen + int64_t(grp) * kTile;
  const int32_t* cg = cmds + int64_t(grp) * kRows * kTile;
  int32_t* rg = rec + int64_t(grp) * kTiles * kTile;

  bool same = true;
  for (int i = lane; i < kTile; i += kWarp) same = same && cl[i] == cl[i & ~(kLanes - 1)];
  same = __all_sync(kFull, same);
  const bool walker = lane < 8;
  const int32_t my_clen = walker ? cl[lane * kLanes] : 0;
  const int32_t* win = row_s + (walker ? lane : 0) * kLanes;
  for (int i = lane; i < kTile; i += kWarp) acc[i] = 0;
  const int rows = same ? nrow : 0;
  int32_t ip = 0, op = 0, cur = 0;
  int tile = 0;
  int32_t next[kTile / kWarp];
  if (rows > 0)
    for (int k = 0; k < kTile / kWarp; ++k) next[k] = cg[lane + kWarp * k];
  for (int r = 0; r < rows; ++r) {
    __syncwarp();
    for (int k = 0; k < kTile / kWarp; ++k) row_s[lane + kWarp * k] = next[k];
    __syncwarp();
    if (r + 1 < rows)
      for (int k = 0; k < kTile / kWarp; ++k) next[k] = cg[int64_t(r + 1) * kTile + lane + kWarp * k];
    for (int b = 0; b < kMaxBursts; ++b) {
      const bool act0 = walker && (static_cast<uint32_t>(ip) >> 7) == static_cast<uint32_t>(r) && ip < my_clen;
      if (!__any_sync(kFull, act0)) break;
      for (int k = 0; k < 4; ++k) {
        if (walker && (static_cast<uint32_t>(ip) >> 7) == static_cast<uint32_t>(r) && ip < my_clen) {
          const int32_t w = win[ip & 127];
          const int32_t cx = w & 7, lit = (w >> 3) & 1, ln = (w >> 4) & 0x7F;
          if (cur < kLanes) acc[lane * kLanes + cur] = lit ? (ip | kIntMin) : ip;
          ++cur;
          ip = add32(ip, cx + lit * ln);
          op = add32(op, ln);
        }
      }
    }
    if (__any_sync(kFull, walker && cur >= 96)) {
      __syncwarp();
      int32_t* dst = rg + (tile < kTiles - 1 ? tile : kTiles - 1) * kTile;
      for (int i = lane; i < kTile; i += kWarp) {
        dst[i] = acc[i];
        acc[i] = 0;
      }
      __syncwarp();
      cur = 0;
      ++tile;
    }
  }
  __syncwarp();
  const int last = tile < kTiles - 1 ? tile : kTiles - 1;
  for (int i = last * kTile + lane; i < kTiles * kTile; i += kWarp)
    rg[i] = same && i < (last + 1) * kTile ? acc[i - last * kTile] : kIntMin;
  const int32_t max_op = __reduce_max_sync(kFull, walker ? op : kIntMin);
  const int32_t max_cur = __reduce_max_sync(kFull, walker ? cur : kIntMin);
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
// One block. drain8: warp k computes record k of each group of 8 on its 128
// lanes (gather through its staged row in shared memory; logroll as 7
// stages of shuffles, each a rotate right by 2**b where the lane's shift has
// bit b); then the first 128 threads store the group's 8 records in order,
// each thread its own lane, so a later record to the same row wins.
// serial: 128 threads, one lane each, one record after another, reading
// the source rows from device memory (256 KiB do not fit shared memory).
constexpr int kDrain8Threads = 8 * kWarp;
constexpr int64_t kDrain8Smem = int64_t(3) * kTile * 4;

template <int kMode>
__global__ void __launch_bounds__(kDrain8Threads)
drain8_kernel(int nrec, int nsrc, const int32_t* __restrict__ q0, const int32_t* __restrict__ r,
              const int32_t* __restrict__ fld, const int32_t* __restrict__ src, int32_t* __restrict__ out,
              long long* __restrict__ cycles) {
  int32_t* stage = shared_words();
  int32_t* zs = stage + kTile;
  int32_t* ks = zs + kTile;
  const int tid = threadIdx.x, k = tid / kWarp, t = tid % kWarp;
  const int last_out = nsrc + 7;
  const long long start = clock64();
  for (int i = tid; i < (nsrc + 8) * kLanes; i += kDrain8Threads) out[i] = kIntMin;
  __syncthreads();
  for (int grp = 0; grp < nrec / 8; ++grp) {
    const int rc = grp * 8 + k;
    const int32_t* row = src + clamp_index(q0[rc], nsrc - 1) * kLanes;
    const int32_t* f = fld + int64_t(rc) * kLanes;
    int32_t z[4];
    for (int j = 0; j < 4; ++j) z[j] = row[t + kWarp * j];
    if (kMode == kDrainGather) {
      for (int j = 0; j < 4; ++j) stage[k * kLanes + t + kWarp * j] = z[j];
      __syncwarp();
      for (int j = 0; j < 4; ++j) {
        const int l = t + kWarp * j;
        z[j] = stage[k * kLanes + ((l + (f[l] & 127)) & 127)];
      }
    } else {
      int32_t sh[4];
      for (int j = 0; j < 4; ++j) sh[j] = f[t + kWarp * j] & 127;
      for (int b = 0; b < 7; ++b) {
        const int s = 1 << b;
        int32_t rolled[4];
        if (s < kWarp) {
          int32_t y[4];
          for (int j = 0; j < 4; ++j) y[j] = __shfl_sync(kFull, z[j], (t - s) & (kWarp - 1));
          for (int j = 0; j < 4; ++j) rolled[j] = t >= s ? y[j] : y[(j + 3) & 3];
        } else {
          for (int j = 0; j < 4; ++j) rolled[j] = z[(j - s / kWarp) & 3];
        }
        for (int j = 0; j < 4; ++j) z[j] = (sh[j] >> b) & 1 ? rolled[j] : z[j];
      }
    }
    for (int j = 0; j < 4; ++j) {
      const int l = t + kWarp * j;
      const int32_t fv = f[l];
      const int32_t ph = (fv >> 7) & 127, lo = (fv >> 14) & 127, n = (fv >> 21) & 0x7F;
      const bool keep = l >= lo && l < lo + n;
      zs[k * kLanes + l] = keep ? add32(z[j], ph) : 0;
      ks[k * kLanes + l] = keep;
    }
    __syncthreads();
    if (tid < kLanes)
      for (int kk = 0; kk < 8; ++kk)
        if (ks[kk * kLanes + tid]) out[clamp_index(r[grp * 8 + kk], last_out) * kLanes + tid] = zs[kk * kLanes + tid];
    __syncthreads();
  }
  if (cycles && tid == 0) *cycles = clock64() - start;
}

__global__ void __launch_bounds__(kLanes)
drain_serial_kernel(int nrec, int nsrc, const int32_t* __restrict__ q0, const int32_t* __restrict__ r,
                    const int32_t* __restrict__ fld, const int32_t* __restrict__ src, int32_t* __restrict__ out,
                    long long* __restrict__ cycles) {
  const int l = threadIdx.x;
  const int last_out = nsrc + 7;
  const long long start = clock64();
  for (int i = l; i < (nsrc + 8) * kLanes; i += kLanes) out[i] = kIntMin;
  __syncthreads();
  for (int t = 0; t < nrec; ++t) {
    const int32_t q = q0[t], f = fld[int64_t(t) * kLanes];
    const int32_t shift = f & 127, ph = (f >> 7) & 127, lo = (f >> 14) & 127, n = (f >> 21) & 0x7F;
    const int j = (l - shift) & 127;
    const int32_t a = src[clamp_index(q, nsrc - 1) * kLanes + j];
    const int32_t b = src[clamp_index(add32(q, 1), nsrc - 1) * kLanes + j];
    const int32_t c = src[clamp_index(add32(q, 2), nsrc - 1) * kLanes + j];
    const bool sel = j >= ph;
    const int32_t rr = r[t];
    if (l >= lo && l < lo + n) out[clamp_index(rr, last_out) * kLanes + l] = sel ? a : b;
    if (l < lo + n - kLanes) out[clamp_index(add32(rr, 1), last_out) * kLanes + l] = sel ? b : c;
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

Shape walk8_shape(int groups) { return {groups, kWarp, int64_t(2) * kTile * 4}; }

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
  return {1, serial ? kLanes : kDrain8Threads, serial ? 0 : kDrain8Smem};
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

}  // extern "C"
