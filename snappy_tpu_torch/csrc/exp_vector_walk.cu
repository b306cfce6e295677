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
// vector registers and SMEM scalars become this card's: a warp per 128-lane
// row with 4 lanes a thread, or one thread where the TPU ran its scalar core.
//
// What bounds them: each is a chain of dependent steps (a select, a load, a
// tag), so its time is the latency of one step times the steps; the bytes
// are a few KiB to a few MiB. The design keeps every step's operands on chip
// (registers, shared memory) so that the latency read is the primitive's own.
// When `cycles` is not null, thread 0 of block 0 writes the clock64() span of
// its block there: the slope of two knobs gives cycles a step without
// assuming a clock rate.

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
// One block; warp s holds sublane s of each of the G chains, lane t the
// lanes t + 32j (j < 4). The window (x[0] as given) stays in registers and,
// for gather, in shared memory: the index picks a lane and a register, so a
// shuffle would need four shuffles and a select per value where one shared
// load picks the word. reduce is a compare and a warp sum. axis 0 selects
// among a thread's own G values; axis 1 reads the other warps' rows through
// two state copies in shared memory, one barrier a step.
constexpr int kChainThreads = 8 * kWarp;

template <int kMode, int G>
__global__ void __launch_bounds__(kChainThreads)
chain_kernel(int reps, const int32_t* __restrict__ x, int32_t* __restrict__ out,
             long long* __restrict__ cycles) {
  int32_t* sm = shared_words();
  const int tid = threadIdx.x, s = tid / kWarp, t = tid % kWarp;
  const long long start = clock64();
  int32_t v[G][4], win[4];
  for (int g = 0; g < G; ++g)
    for (int j = 0; j < 4; ++j) v[g][j] = x[(g * 8 + s) * kLanes + t + kWarp * j];
  for (int j = 0; j < 4; ++j) win[j] = v[0][j];
  if (kMode == kGather) {
    for (int j = 0; j < 4; ++j) sm[s * kLanes + t + kWarp * j] = win[j];
    __syncwarp();
  }
  for (int i = 0; i < reps; ++i) {
    if (kMode == kAlu) {
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j) v[g][j] = add32((v[g][j] & 127) ^ v[g][j], 1);
    } else if (kMode == kAxis0) {
      int32_t nv[G][4];
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j) {
          const int idx = v[g][j] & 7;
          int32_t sel = kIntMin;
          for (int h = 0; h < G; ++h) sel = idx == h ? v[h][j] : sel;
          nv[g][j] = add32(sel, 1);
        }
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j) v[g][j] = nv[g][j];
    } else if (kMode == kAxis1) {
      int32_t* buf = sm + (i & 1) * G * kTile;
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j) buf[(g * 8 + s) * kLanes + t + kWarp * j] = v[g][j];
      __syncthreads();
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j) {
          const int idx = v[g][j] & 127;
          v[g][j] = add32(idx < 8 ? buf[(g * 8 + idx) * kLanes + t + kWarp * j] : kIntMin, 1);
        }
    } else if (kMode == kGather) {
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < 4; ++j)
          v[g][j] = add32(add32(v[g][j], sm[s * kLanes + (v[g][j] & 127)] & 7), 1);
    } else {
      for (int g = 0; g < G; ++g) {
        unsigned part = 0;
        for (int j = 0; j < 4; ++j)
          part += (v[g][j] & 127) == t + kWarp * j ? static_cast<uint32_t>(win[j]) : 0u;
        const int32_t w = static_cast<int32_t>(__reduce_add_sync(kFull, part));
        for (int j = 0; j < 4; ++j) v[g][j] = add32(add32(v[g][j], w & 7), 1);
      }
    }
  }
  for (int g = 0; g < G; ++g)
    for (int j = 0; j < 4; ++j) out[(g * 8 + s) * kLanes + t + kWarp * j] = v[g][j];
  if (cycles) {
    __syncthreads();
    if (tid == 0) *cycles = clock64() - start;
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
// One block of 128 threads, one lane each; src, q and r staged in shared
// memory (the reference's VMEM and SMEM), the records in order. The second
// store is issued under each lane's mask (always), behind a branch on the
// record's lo + n that every thread takes alike (when), or not at all.
constexpr int64_t kWhenSmem = int64_t(kWhenSrcRows * kLanes + 2 * kWhenRecords) * 4;

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
  for (int g = 0; g < ngroups; ++g) {
    for (int k = 0; k < 8; ++k) {
      const int t = (g % (kWhenRecords / 8)) * 8 + k;
      const int32_t q0 = sq[t], rr = sr[t];
      const int32_t lo = q0 & 127, n = (q0 >> 7) & 63;
      const int base = (q0 & 255) * kLanes, j = (l - lo) & 127;
      const int32_t a = ssrc[base + j], b = ssrc[base + kLanes + j];
      const bool sel = j >= lo;
      if (l >= lo && l < lo + n) out[clamp_index(rr, kWhenOutRows - 1) * kLanes + l] = sel ? a : b;
      if (kMode == kAlways || (kMode == kWhen && lo + n > kLanes)) {
        if (l < lo + n - kLanes) out[clamp_index(add32(rr, 1), kWhenOutRows - 1) * kLanes + l] = sel ? b : a;
      }
    }
  }
  __syncthreads();
  if (cycles && l == 0) *cycles = clock64() - start;
}

// ------------------------------------------------------------------ dispatch
// The instantiation a mode names (null for none), its threads and its
// dynamic shared memory.
using ChainKernel = void (*)(int, const int32_t*, int32_t*, long long*);
using DrainKernel = void (*)(int, int, const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                             int32_t*, long long*);
using ScalarKernel = void (*)(int, const int32_t*, int32_t*, long long*);
using WhenKernel = void (*)(int, const int32_t*, const int32_t*, const int32_t*, int32_t*, long long*);

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

int64_t chain_smem(int mode, int g) {
  return mode == kGather ? int64_t(kTile) * 4 : mode == kAxis1 ? int64_t(2) * g * kTile * 4 : 0;
}

DrainKernel drain_for(int mode) {
  switch (mode) {
    case kDrainGather: return drain8_kernel<kDrainGather>;
    case kDrainLogroll: return drain8_kernel<kDrainLogroll>;
    case kDrainSerial: return drain_serial_kernel;
    default: return nullptr;
  }
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

WhenKernel when_for(int mode) {
  switch (mode) {
    case kAlways: return when_drain_kernel<kAlways>;
    case kWhen: return when_drain_kernel<kWhen>;
    case kNone: return when_drain_kernel<kNone>;
    default: return nullptr;
  }
}

}  // namespace

// ------------------------------------------------------------------ launch

namespace {

template <class Kernel, class... Args>
int launch(Kernel kernel, int blocks, int threads, int64_t smem, void* stream, Args... args) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  if (blocks <= 0) return cudaSuccess;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(unsigned(blocks)), dim3(unsigned(threads)), size_t(smem), static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches one probe on `stream` and returns the
// cudaError_t of the launch (0 on success); none synchronises. `cycles` is a
// long long on the card, or null.

int snappy_probe_chain(int mode, int g, int reps, const void* x, void* out, void* cycles, void* stream) {
  return launch(chain_for(mode, g), 1, kChainThreads, chain_smem(mode, g), stream, reps,
                static_cast<const int32_t*>(x), static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_walk8(int groups, int nrow, const void* clen, const void* cmds, void* rec, void* meta,
                       void* cycles, void* stream) {
  return launch(walk8_kernel, groups, kWarp, int64_t(2) * kTile * 4, stream, nrow,
                static_cast<const int32_t*>(clen), static_cast<const int32_t*>(cmds), static_cast<int32_t*>(rec),
                static_cast<int32_t*>(meta), static_cast<long long*>(cycles));
}

int snappy_probe_walk_scalar(int blocks, int64_t rounds, const void* clen, const void* cmds, void* meta,
                             void* cycles, void* stream) {
  return launch(walk_scalar_kernel, blocks, kWalkThreads, kWalkSmem, stream, rounds,
                static_cast<const int32_t*>(clen), static_cast<const int32_t*>(cmds), static_cast<int32_t*>(meta),
                static_cast<long long*>(cycles));
}

int snappy_probe_drain(int mode, int nrec, int nsrc, const void* q0, const void* r, const void* fld,
                       const void* src, void* out, void* cycles, void* stream) {
  const bool serial = mode == kDrainSerial;
  return launch(drain_for(mode), 1, serial ? kLanes : kDrain8Threads, serial ? 0 : kDrain8Smem, stream, nrec, nsrc,
                static_cast<const int32_t*>(q0), static_cast<const int32_t*>(r), static_cast<const int32_t*>(fld),
                static_cast<const int32_t*>(src), static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_scalar_loop(int work, int unroll, int cond, int chain, int n, const void* x, void* out,
                             void* cycles, void* stream) {
  return launch(scalar_loop_for(work, unroll, cond, chain), 1, kWarp, int64_t(1024) * 4, stream, n,
                static_cast<const int32_t*>(x), static_cast<int32_t*>(out), static_cast<long long*>(cycles));
}

int snappy_probe_when_drain(int mode, int ngroups, const void* q, const void* r, const void* src, void* out,
                            void* cycles, void* stream) {
  return launch(when_for(mode), 1, kLanes, kWhenSmem, stream, ngroups, static_cast<const int32_t*>(q),
                static_cast<const int32_t*>(r), static_cast<const int32_t*>(src), static_cast<int32_t*>(out),
                static_cast<long long*>(cycles));
}

}  // extern "C"
