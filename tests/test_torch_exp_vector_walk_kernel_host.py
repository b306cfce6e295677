"""The probe kernels' own source, compiled with g++ as a host emulation of
their thread blocks, against the plain versions on the CPU.

The kernels cannot run without a card, so this holds their logic here: the
device code of ``snappy_tpu_torch/csrc/exp_vector_walk.cu`` (everything before
its launch section) is compiled unchanged but for two textual substitutions,
with one ``std::thread`` per thread of a block, a ``std::barrier`` for
``__syncthreads`` and one per warp for ``__syncwarp``, the warp intrinsics
(``__shfl_sync``, ``__reduce_add_sync``, ``__reduce_max_sync``,
``__any_sync``, ``__all_sync``) through a per-warp exchange array, Hopper's
DPX clamps as plain min and max, and a static buffer for shared memory. The
asynchronous copies (cp.async) are queued by thread in the groups it commits
and land when that thread waits for them, the latest a card lands them, so
a stage read before the wait that covers it reads stale words; one case runs
each ring kernel with every copy landing as it is issued, the earliest. The
predicated stores are their source's host branches. The blocks of a grid
run one after another. The kernels are picked, and their
grids, block shapes and shared memory taken, by the source's own dispatch
functions.

Tolerance: exact, whole arrays, and nothing written outside them (a guard
zone on each side of every output).
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import probes_torch as pt
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools.exp_vector_walk import WHEN_EDGE_ROWS, drain_gate_inputs, drain_inputs, when_inputs

GUARD = 64  # canary words on each side of an output
CANARY = 0x5A5A5A5A

_PRELUDE = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
constexpr int kEmuMaxWarps = 8;
static std::barrier<>* g_block_bar;
static std::barrier<>* g_warp_bar[kEmuMaxWarps];
static uint32_t g_xchg[kEmuMaxWarps][32];
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
static inline long long clock64() { return 0; }
// Every lane of the warp posts v; `all` receives the 32 values.
static inline void emu_post(uint32_t v, uint32_t* all) {
  const int64_t w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncwarp();
  g_xchg[w][l] = v;
  __syncwarp();
  for (int i = 0; i < 32; ++i) all[i] = g_xchg[w][i];
}
template <class T>
static inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  uint32_t all[32];
  emu_post(static_cast<uint32_t>(v), all);
  return static_cast<T>(all[(threadIdx.x % 32 & ~(width - 1)) | (src & (width - 1))]);
}
static inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  uint32_t all[32];
  emu_post(v, all);
  unsigned s = 0;
  for (uint32_t a : all) s += a;
  return s;
}
static inline int __reduce_max_sync(unsigned, int v) {
  uint32_t all[32];
  emu_post(static_cast<uint32_t>(v), all);
  int m = static_cast<int>(all[0]);
  for (uint32_t a : all) m = static_cast<int>(a) > m ? static_cast<int>(a) : m;
  return m;
}
static inline int __any_sync(unsigned, int p) {
  uint32_t all[32];
  emu_post(p != 0, all);
  for (uint32_t a : all) if (a) return 1;
  return 0;
}
static inline int __all_sync(unsigned, int p) {
  uint32_t all[32];
  emu_post(p != 0, all);
  for (uint32_t a : all) if (!a) return 0;
  return 1;
}
static inline unsigned __reduce_xor_sync(unsigned, unsigned v) {
  uint32_t all[32];
  emu_post(v, all);
  unsigned x = 0;
  for (uint32_t a : all) x ^= a;
  return x;
}
struct alignas(8) int2 { int32_t x, y; };
struct alignas(16) int4 { int32_t x, y, z, w; };
// Hopper's DPX: max(min(a, b), 0) and max(min(a + b, c), 0), a + b wrapping.
static inline int __vimin_s32_relu(int a, int b) { return std::max(std::min(a, b), 0); }
static inline int __viaddmin_s32_relu(int a, int b, int c) {
  return __vimin_s32_relu(static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b)), c);
}
constexpr int64_t kEmuSmemWords = (1 << 18) / 4;
alignas(16) static int32_t g_smem[kEmuSmemWords];
// cp.async: each thread's copies, in the groups it commits. With g_copy_late
// a group lands when its thread waits for it (the latest a card lands it),
// so a read of a stage before the wait that covers it sees stale words;
// else a copy lands as it is issued (the earliest), so a stage written while
// another thread still reads it changes under that thread.
struct EmuCopy { int32_t* dst; const int32_t* src; int n; };
static bool g_copy_late = true;
static std::atomic<bool> g_misaligned{false};  // a 16-byte copy from or to an address off 16 bytes
thread_local std::vector<std::vector<EmuCopy>> t_groups;
thread_local std::vector<EmuCopy> t_open;
static inline void emu_land(const EmuCopy& c) { for (int i = 0; i < c.n; ++i) c.dst[i] = c.src[i]; }
static inline void emu_copy(int32_t* dst, const int32_t* src, int n) {
  if (n == 4 && ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15)) g_misaligned = true;
  if (g_copy_late) t_open.push_back({dst, src, n}); else emu_land({dst, src, n});
}
static inline void emu_commit() { t_groups.push_back(std::move(t_open)); t_open.clear(); }
static inline void emu_wait(size_t n) {
  while (t_groups.size() > n) {
    for (const EmuCopy& c : t_groups.front()) emu_land(c);
    t_groups.erase(t_groups.begin());
  }
}
#define SNAPPY_HOST_COPY(dst, src, n) emu_copy(dst, src, n)
#define SNAPPY_HOST_COMMIT() emu_commit()
#define SNAPPY_HOST_WAIT(n) emu_wait(n)
"""

_HARNESS = r"""
// Run `body` as the blocks of `shape`, one block at a time, each as
// `shape.threads` std::threads; 2 when the emulation cannot hold the shape,
// 3 when a 16-byte copy was not 16-byte aligned (cp.async faults there).
template <class F>
static int emu_grid(Shape shape, F body) {
  if (shape.threads % 32 || shape.threads / 32 > kEmuMaxWarps || shape.smem > kEmuSmemWords * 4) return 2;
  std::barrier<> bar(shape.threads);
  g_block_bar = &bar;
  g_misaligned = false;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; w < shape.threads / 32; ++w) {
    warp_bars.emplace_back(new std::barrier<>(32));
    g_warp_bar[w] = warp_bars.back().get();
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < shape.threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (int b = 0; b < shape.blocks; ++b) {
        blockIdx.x = b;
        body();
        emu_commit();  // copies still in flight at the end land, as on the card
        emu_wait(0);
        bar.arrive_and_wait();
      }
    });
  for (auto& t : ts) t.join();
  return g_misaligned ? 3 : 0;
}

extern "C" void emu_copy_late(int late) { g_copy_late = late != 0; }

extern "C" int emu_chain(int mode, int g, int reps, const int32_t* x, int32_t* out) {
  ChainKernel k = chain_for(mode, g);
  if (!k) return 1;
  return emu_grid(chain_shape(mode, g), [&] { k(reps, x, out, nullptr); });
}

extern "C" int emu_chain_blocks(int mode, int g) { return chain_shape(mode, g).blocks; }
extern "C" int emu_chain_threads(int mode, int g) { return chain_shape(mode, g).threads; }

extern "C" int emu_walk8(int groups, int nrow, const int32_t* clen, const int32_t* cmds, int32_t* rec, int32_t* meta) {
  return emu_grid(walk8_shape(groups), [&] { walk8_kernel(nrow, clen, cmds, rec, meta, nullptr); });
}

extern "C" int emu_walk_scalar(int blocks, int64_t rounds, const int32_t* clen, const int32_t* cmds, int32_t* meta) {
  return emu_grid(walk_scalar_shape(blocks), [&] { walk_scalar_kernel(rounds, clen, cmds, meta, nullptr); });
}

extern "C" int emu_drain(int mode, int nrec, int nsrc, const int32_t* q0, const int32_t* r, const int32_t* fld,
                         const int32_t* src, int32_t* out) {
  DrainKernel k = drain_for(mode);
  if (!k) return 1;
  return emu_grid(drain_shape(mode), [&] { k(nrec, nsrc, q0, r, fld, src, out, nullptr); });
}

extern "C" int emu_scalar_loop(int work, int unroll, int cond, int chain, int n, const int32_t* x, int32_t* out) {
  ScalarKernel k = scalar_loop_for(work, unroll, cond, chain);
  if (!k) return 1;
  return emu_grid(scalar_loop_shape(), [&] { k(n, x, out, nullptr); });
}

extern "C" int emu_when_drain(int mode, int ngroups, const int32_t* q, const int32_t* r, const int32_t* src,
                              int32_t* out) {
  WhenKernel k = when_for(mode);
  if (!k) return 1;
  return emu_grid(when_shape(), [&] { k(ngroups, q, r, src, out, nullptr); });
}

extern "C" int emu_l2_read(int tiles, const int32_t* x, int32_t* out) {
  return emu_grid(l2_read_shape(), [&] { l2_read_kernel(tiles, x, out, nullptr); });
}
"""

# (text in the kernel source, its host replacement)
_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) int32_t smem_words[];", "int32_t* smem_words = g_smem;"),
]
_CUT = "// ------------------------------------------------------------------ launch"


def _emulation_source() -> str:
    src = (CSRC / "exp_vector_walk.cu").read_text()
    assert src.count(_CUT) == 1, "kernel source no longer holds its launch section marker"
    src = src[: src.index(_CUT)]
    for old, new in _SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return _PRELUDE + src + _HARNESS


class _Out:
    """An int32 output with a guard zone on each side."""

    def __init__(self, shape):
        self.shape = shape
        self.buf = np.full(int(np.prod(shape)) + 2 * GUARD, CANARY, np.int32)
        self.ptr = self.buf.ctypes.data + 4 * GUARD

    def get(self):
        assert (self.buf[:GUARD] == CANARY).all() and (self.buf[-GUARD:] == CANARY).all(), "wrote outside the output"
        return self.buf[GUARD:-GUARD].reshape(self.shape)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    d = tmp_path_factory.mktemp("exp_vector_walk_host")
    cpp, so = d / "exp_vector_walk_host.cpp", d / "exp_vector_walk_host.so"
    cpp.write_text(_emulation_source())
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fno-strict-aliasing", "-pthread", "-fPIC", "-shared", "-Wall", str(cpp),
         "-o", str(so)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.emu_chain.argtypes = [i, i, i, p, p]
    lib.emu_chain_blocks.argtypes = [i, i]
    lib.emu_chain_threads.argtypes = [i, i]
    lib.emu_walk8.argtypes = [i, i, p, p, p, p]
    lib.emu_walk_scalar.argtypes = [i, i64, p, p, p]
    lib.emu_drain.argtypes = [i, i, i, p, p, p, p, p]
    lib.emu_scalar_loop.argtypes = [i, i, i, i, i, p, p]
    lib.emu_when_drain.argtypes = [i, i, p, p, p, p]
    lib.emu_l2_read.argtypes = [i, p, p]
    lib.emu_copy_late.argtypes = [i]
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.dtype == np.int32 and a.flags.c_contiguous
    return a.ctypes.data


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chain(emu, x, reps, mode):
    out = _Out(x.shape)
    assert emu.emu_chain(pt.CHAIN_MODES.index(mode), x.shape[0], reps, _ptr(x), out.ptr) == 0
    return out.get()


@pytest.mark.parametrize("reps", [0, 1, 23, 200])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("mode", pt.CHAIN_MODES)
def test_chain(emu, mode, g, reps):
    """Every block of the source's grid: reduce's 8 (one a sublane row, a
    warp a chain), the other modes' 32 one-warp blocks (4 columns of 8
    sublanes each)."""
    m = pt.CHAIN_MODES.index(mode)
    want = (8, 32 * g) if mode == "reduce" else (pt.LANES // 4, 32)
    assert (emu.emu_chain_blocks(m, g), emu.emu_chain_threads(m, g)) == want
    x = np.random.default_rng(2).integers(0, 1 << 20, (g, 8, pt.LANES)).astype(np.int32)
    np.testing.assert_array_equal(_chain(emu, x, reps, mode), pt.chain(reps, _t(x), mode).numpy())


@pytest.mark.parametrize("g", [1, 4])
def test_chain_axis1_mostly_past_the_sublanes(emu, g):
    """Axis 1 where ~90% of the indices are >= 8 (those read INT_MIN) and
    the rest pick sublanes 0-7 of their own column, through the shuffle."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 20, (g, 8, pt.LANES)).astype(np.int32)
    low = rng.random(x.shape) < 0.1
    x = np.where(low, x & ~127 | (x & 7), x | 8).astype(np.int32)
    for reps in (1, 2, 23):
        np.testing.assert_array_equal(_chain(emu, x, reps, "axis1"), pt.chain(reps, _t(x), "axis1").numpy())


def _walk8(emu, clen, cmds_g, nrow):
    g = cmds_g.shape[0]
    rec, meta = _Out((g, pt.T_TILES, 8, pt.LANES)), _Out((g, 1, 2))
    assert emu.emu_walk8(g, nrow, _ptr(clen), _ptr(cmds_g), rec.ptr, meta.ptr) == 0
    return rec.get(), meta.get()


def _groups(cmds):
    return cmds.reshape(-1, 8, pt.R_ROWS, pt.LANES).transpose(0, 2, 1, 3).copy()


@pytest.mark.parametrize(
    "max_advance, nrow", [(7, 45), (7, pt.R_ROWS), (8, pt.R_ROWS)], ids=["45-rows", "full", "stalled"]
)
def test_walk8(emu, max_advance, nrow):
    """Two groups; on the reference's data (max_advance 8) walks stall and
    rows end at the burst cap, as in the plain version."""
    cmds_g = _groups(pt.synth_cmds(16, seed=1, max_advance=max_advance)[0])
    clen = np.full((2, 8, pt.LANES), pt.NCP, np.int32)
    clen[1, 5] = 3_000
    rec, meta = _walk8(emu, clen, cmds_g, nrow)
    p_rec, p_meta = pt.walk8(nrow, _t(clen), _t(cmds_g))
    np.testing.assert_array_equal(meta, p_meta.numpy())
    np.testing.assert_array_equal(rec, p_rec.numpy())


def test_walk8_refuses_a_length_that_varies_over_lanes(emu):
    cmds_g = _groups(pt.synth_cmds(16, seed=1, max_advance=7)[0])
    clen = np.full((2, 8, pt.LANES), pt.NCP, np.int32)
    clen[0, 2, 77] = 100
    rec, meta = _walk8(emu, clen, cmds_g, 20)
    assert meta[0].tolist() == [[-1, -1]] and (rec[0] == pt.INT_MIN).all()
    p_rec, p_meta = pt.walk8(20, _t(clen[1:]), _t(cmds_g[1:]))
    np.testing.assert_array_equal(meta[1:], p_meta.numpy())
    np.testing.assert_array_equal(rec[1:], p_rec.numpy())


def _in_step(nrow_words: np.ndarray, groups: int = 1) -> np.ndarray:
    """One block's command words, walked by all 8 walks of each group."""
    return np.broadcast_to(nrow_words.reshape(1, pt.R_ROWS, 1, pt.LANES), (groups, pt.R_ROWS, 8, pt.LANES)).copy()


def _hold_walk8(emu, clen, cmds_g, nrow):
    rec, meta = _walk8(emu, clen, cmds_g, nrow)
    p_rec, p_meta = pt.walk8(nrow, _t(clen), _t(cmds_g))
    np.testing.assert_array_equal(meta, p_meta.numpy())
    np.testing.assert_array_equal(rec, p_rec.numpy())
    return rec


@pytest.mark.parametrize("nrow", [0, 1, 7, 45])
def test_walk8_walks_in_step(emu, nrow):
    """All 8 walks of a group read the same words, so their cursors move in
    step and each step's 8 appends go to one position of 8 walks: in a
    walk-major tile of 128-word rows they would share a bank."""
    cmds_g = _in_step(pt.synth_cmds(1, seed=3, max_advance=7)[0], groups=2)
    clen = np.full((2, 8, pt.LANES), pt.NCP, np.int32)
    _hold_walk8(emu, clen, cmds_g, nrow)


def test_walk8_walks_end_mid_burst(emu):
    """Lengths that end each walk at another step of a burst and of a row,
    one of them before the first tag."""
    cmds_g = _groups(pt.synth_cmds(16, seed=5, max_advance=7)[0])
    ends = [[0, 1, 2, 129, 130, 5003, 17001, pt.NCP - 1], [3, 5, 6, 7, 11, 250, 251, 9999]]
    clen = np.broadcast_to(np.array(ends, np.int32)[:, :, None], (2, 8, pt.LANES)).copy()
    _hold_walk8(emu, clen, cmds_g, 100)


def test_walk8_stalls_at_the_burst_cap(emu):
    """A tag that advances 0 keeps its walk in the row for all kMaxBursts
    bursts of 4 steps; the cursor passes 128 (appends stop there) and the
    tile is flushed after every such row. Other walks of the group move on."""
    cmds = pt.synth_cmds(8, seed=6, max_advance=7)[0].reshape(8, pt.R_ROWS, pt.LANES)
    cmds[2, 3, :] = 0  # walk 2 stalls in row 3 wherever it lands: a copy of advance 0
    cmds[5, 5, :] = 8  # walk 5 in row 5: a literal of length 0, advance 0
    cmds_g = cmds.reshape(1, 8, pt.R_ROWS, pt.LANES).transpose(0, 2, 1, 3).copy()
    clen = np.full((1, 8, pt.LANES), pt.NCP, np.int32)
    rec = _hold_walk8(emu, clen, cmds_g, 12)
    for w in (2, 5):  # a tile that ends in appends of the one ip where the walk stalled, up to position 127
        tail = rec[0, :, w, -16:]
        assert ((tail == tail[:, -1:]).all(1) & (tail[:, -1] != 0) & (tail[:, -1] != pt.INT_MIN)).any()


@pytest.mark.parametrize("nrow", [97, pt.R_ROWS])
def test_walk8_tile_clamps_at_95(emu, nrow):
    """Walks of advance 1 take all 128 steps of every row (the burst cap is
    what ends each row), so each row flushes a full tile: past 96 rows the
    flushes land on tile 95, the last one wins, and the end stores there too."""
    words = np.full((pt.R_ROWS, pt.LANES), 1, np.int32)
    cmds_g = _in_step(words)
    cmds_g[0, :, 6] = pt.synth_cmds(1, seed=8, max_advance=7)[0].reshape(pt.R_ROWS, pt.LANES)  # one walk apart
    clen = np.full((1, 8, pt.LANES), pt.NCP, np.int32)
    _hold_walk8(emu, clen, cmds_g, nrow)


@pytest.mark.parametrize("knob, max_advance", [(0, 8), (1, 8), (2, 7)])
def test_walk_scalar(emu, knob, max_advance):
    cmds, _ = pt.synth_cmds(3, max_advance=max_advance)
    clen = np.array([pt.NCP, 5_000, pt.NCP + 300], np.int32).reshape(3, 1, 1)
    meta = _Out((3, 1, 2))
    rounds = knob * pt.NCP // 5 // 16 + 1
    assert emu.emu_walk_scalar(3, rounds, _ptr(clen), _ptr(cmds), meta.ptr) == 0
    np.testing.assert_array_equal(meta.get(), pt.walk_scalar(knob, _t(clen), _t(cmds.reshape(3, 1, pt.NCP))).numpy())


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
@pytest.mark.parametrize("fields", ["per-record", "per-lane"])
def test_drain(emu, mode, fields):
    q0, r, fld, src = drain_inputs()
    if fields == "per-lane":
        fld = np.random.default_rng(9).integers(0, 1 << 28, fld.shape).astype(np.int32)
        r[1::4] = r[::4]
    q0[5], r[9] = pt.NSRC + 40, -3  # rows outside the arrays: clamped
    for knob in (0, 68, 512):
        out = _Out((pt.NSRC + 8, pt.LANES))
        assert emu.emu_drain(pt.DRAIN_MODES.index(mode), knob, pt.NSRC, *map(_ptr, (q0, r, fld, src)), out.ptr) == 0
        np.testing.assert_array_equal(out.get(), pt.drain(knob, _t(q0), _t(r), _t(fld), _t(src), mode).numpy())


@pytest.mark.parametrize("variant", pt.SCALAR_VARIANTS, ids=[v[0] for v in pt.SCALAR_VARIANTS])
def test_scalar_loop(emu, variant):
    _, work, unroll, cond, chain = variant
    x = np.random.default_rng(6).integers(-(1 << 31), 1 << 31, 1024).astype(np.int32)
    for n in (0, 37, 300):
        out = _Out((1,))
        assert emu.emu_scalar_loop(work, unroll, int(cond), int(chain), n, _ptr(x), out.ptr) == 0
        np.testing.assert_array_equal(out.get(), pt.scalar_loop(n, _t(x), work, unroll, cond, chain).numpy())


def test_unknown_variants_are_refused(emu):
    x = np.zeros(1024, np.int32)
    out = _Out((4, 8, pt.LANES))
    assert emu.emu_scalar_loop(5, 1, 0, 0, 10, _ptr(x), out.ptr) == 1
    assert emu.emu_chain(0, 2, 1, _ptr(np.zeros((2, 8, pt.LANES), np.int32)), out.ptr) == 1
    assert emu.emu_drain(3, 8, pt.NSRC, *(_ptr(x),) * 4, out.ptr) == 1


RING = 96  # records the drains' ring holds: kDrainStages batches of two groups of 8


def _drain(emu, knob, q0, r, fld, src, mode):
    nsrc = src.shape[0]
    out = _Out((nsrc + 8, pt.LANES))
    assert emu.emu_drain(pt.DRAIN_MODES.index(mode), knob, nsrc, *map(_ptr, (q0, r, fld, src)), out.ptr) == 0
    want = pt.drain(knob, *(_t(a) for a in (q0, r, fld, src)), mode).numpy()
    np.testing.assert_array_equal(out.get(), want)


def _knobs(mode):
    """0, one group, and runs that wrap the ring but end off a multiple of
    its records, on an odd group (half a batch; serial: also off a group)."""
    odd = 3 if mode == "serial" else 0
    return (0, 8, RING + 56 + odd, 3 * RING + 72 + odd)


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
def test_drain_later_record_wins(emu, mode):
    """Every record stores to output row 5 (serial: and row 6), so each
    lane's last record in order must win, across groups and ring stages."""
    q0, r, fld, src = drain_gate_inputs()[0]
    r[:] = 5
    for knob in _knobs(mode):
        _drain(emu, knob, q0, r, fld, src, mode)


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
def test_drain_clamps_rows(emu, mode):
    """q0 and r past either end (INT_MIN and INT_MAX among them; r + 1
    wraps at INT_MAX), as the tool's card gate holds them."""
    q0, r, fld, src = drain_gate_inputs()[1]
    for knob in _knobs(mode):
        _drain(emu, knob, q0, r, fld, src, mode)


@pytest.mark.parametrize("nsrc", [1, 3, 2000])
@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
def test_drain_source_sizes(emu, mode, nsrc):
    """One source row, three (q0 + 2 past the end), and 2000 (1 MiB, far
    more than shared memory holds), with rows drawn past the ends too."""
    rng = np.random.default_rng(nsrc)
    _, _, fld, _ = drain_gate_inputs()[0]
    n = 2 * RING
    q0 = rng.integers(-3, nsrc + 4, pt.NREC).astype(np.int32)
    r = rng.integers(-3, nsrc + 12, pt.NREC).astype(np.int32)
    src = rng.integers(-(1 << 31), 1 << 31, (nsrc, pt.LANES)).astype(np.int32)
    _drain(emu, n + (5 if mode == "serial" else 0), q0, r, fld, src, mode)


def _serial_wrapped(knob, q0, src):
    """The serial drain's three rows a record, q0 + 1 and q0 + 2 summed in
    int32 (wrapping, as the reference's arithmetic does) and clamped into
    src, as a source of three rows a record (and as many rows again as src,
    so that no output row clamps otherwise) and the q0 that names them: the
    plain version drains those to the same output rows."""
    q = (q0[:knob].astype(np.int64)[:, None] + np.arange(3) + (1 << 31)) % (1 << 32) - (1 << 31)
    rows = src[np.clip(q, 0, src.shape[0] - 1).reshape(-1)]
    return np.arange(q0.size, dtype=np.int32) * 3, np.concatenate([rows, np.zeros_like(src)])


def test_drain_serial_wraps_q0_near_int_max(emu):
    """q0 at INT_MAX - 2, INT_MAX - 1 and INT_MAX: q0 + 1 and q0 + 2 wrap to
    INT_MIN and clamp to row 0, as in the reference (which
    tests/test_torch_exp_vector_walk.py holds to the same rows) and the
    plain version: the kernel is held to the plain version on the rows the
    wrap picks, and on the raw ones."""
    q0, r, fld, src = drain_gate_inputs()[0]
    q0[::3] = np.resize(np.array([(1 << 31) - 3, (1 << 31) - 2, (1 << 31) - 1], np.int32), q0[::3].shape)
    knob, rows = RING + 59, src.shape[0] + 8
    out = _Out((rows, pt.LANES))
    assert emu.emu_drain(pt.DRAIN_MODES.index("serial"), knob, src.shape[0], *map(_ptr, (q0, r, fld, src)),
                         out.ptr) == 0
    wq0, wsrc = _serial_wrapped(knob, q0, src)
    want = pt.drain(knob, _t(wq0), _t(r), _t(fld), _t(wsrc), "serial").numpy()
    assert (want[rows:] == pt.INT_MIN).all()
    np.testing.assert_array_equal(out.get(), want[:rows])
    np.testing.assert_array_equal(out.get(), pt.drain(knob, *(_t(a) for a in (q0, r, fld, src)), "serial").numpy())


def _misaligned(a):
    buf = np.empty(a.size + 1, a.dtype)
    out = buf[1:].reshape(a.shape)
    out[...] = a
    assert out.ctypes.data % 16
    return out


@pytest.mark.parametrize("kernel", ["gather", "serial", "walk8", "l2_read"])
def test_row_copies_need_16_byte_alignment(emu, kernel):
    """The kernels copy rows into shared memory 16 bytes a piece, which
    cp.async takes only between 16-byte aligned addresses: the emulation
    reports any other (rc 3), so every case here ran aligned; the wrappers
    of ops/cuda_probes.py copy a misaligned tensor before a launch."""
    if kernel == "walk8":
        cmds_g = _misaligned(_groups(pt.synth_cmds(8, seed=9, max_advance=7)[0]))
        rec, meta = _Out((1, pt.T_TILES, 8, pt.LANES)), _Out((1, 1, 2))
        clen = np.full((1, 8, pt.LANES), 20_000, np.int32)
        assert emu.emu_walk8(1, 60, _ptr(clen), _ptr(cmds_g), rec.ptr, meta.ptr) == 3
    elif kernel == "l2_read":
        x, out = _misaligned(np.arange(2 * 4096, dtype=np.int32)), _Out((1,))
        assert emu.emu_l2_read(2, _ptr(x), out.ptr) == 3
    else:
        q0, r, fld, src = drain_gate_inputs()[0]
        src, out = _misaligned(src), _Out((src.shape[0] + 8, pt.LANES))
        assert emu.emu_drain(pt.DRAIN_MODES.index(kernel), 64, src.shape[0], *map(_ptr, (q0, r, fld, src)),
                             out.ptr) == 3


@pytest.mark.parametrize("tiles", [1, 7, 8, 21])
def test_l2_read(emu, tiles):
    """The one-block read XORs every word of its tiles, through the ring."""
    x = np.random.default_rng(tiles).integers(-(1 << 31), 1 << 31, tiles * 4096).astype(np.int32)
    out = _Out((1,))
    assert emu.emu_l2_read(tiles, _ptr(x), out.ptr) == 0
    np.testing.assert_array_equal(out.get(), pt.xor_words(_t(x)).numpy())


@pytest.mark.parametrize("kernel", ["gather", "logroll", "serial", "walk8", "l2_read"])
def test_ring_kernels_with_copies_landing_at_issue(emu, kernel):
    """The other end of a copy's timing: every copy lands as it is issued,
    so a stage refilled while a thread still reads it changes under it."""
    emu.emu_copy_late(0)
    try:
        if kernel == "walk8":
            cmds_g = _groups(pt.synth_cmds(8, seed=2, max_advance=7)[0])
            _hold_walk8(emu, np.full((1, 8, pt.LANES), pt.NCP, np.int32), cmds_g, 30)
        elif kernel == "l2_read":
            test_l2_read(emu, 21)
        else:
            q0, r, fld, src = drain_gate_inputs()[1]
            r[::3] = 5
            _drain(emu, 2 * RING + 8, q0, r, fld, src, kernel)
    finally:
        emu.emu_copy_late(1)


def _when(emu, knob, q, r, src, mode):
    out = _Out((pt.WHEN_OUT_ROWS, pt.LANES))
    assert emu.emu_when_drain(pt.WHEN_MODES.index(mode), knob // 8, *map(_ptr, (q, r, src)), out.ptr) == 0
    np.testing.assert_array_equal(out.get(), pt.when_drain(knob, _t(q), _t(r), _t(src), mode).numpy())


@pytest.mark.parametrize("mode", pt.WHEN_MODES)
def test_when_drain(emu, mode):
    q, r, src = when_inputs()
    r[7] = 600  # a row outside the output: clamped
    for knob in (100, pt.WHEN_RECORDS + 64):
        _when(emu, knob, q, r, src, mode)


@pytest.mark.parametrize("mode", pt.WHEN_MODES)
def test_when_drain_later_record_wins(emu, mode):
    """Every record stores to rows 5 and 6 (and 7 when it crosses 128), so
    each lane's last record in order must win, across groups and passes:
    a kernel that let a later record's store pass an earlier one's differs."""
    q, r, src = when_inputs(seed=12)
    r[:] = np.random.default_rng(12).integers(5, 7, r.shape)
    for knob in (8, 96, pt.WHEN_RECORDS + 24):
        _when(emu, knob, q, r, src, mode)


@pytest.mark.parametrize("mode", pt.WHEN_MODES)
def test_when_drain_clamps_rows(emu, mode):
    """Rows past either end of the output, and r + 1 wrapping at INT_MAX,
    are clamped into it, as the plain version clamps them."""
    q, r, src = when_inputs()
    r[: 8 * 64 : 4] = np.resize(np.array(WHEN_EDGE_ROWS, np.int32), 128)
    _when(emu, 8 * 64, q, r, src, mode)
