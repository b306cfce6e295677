"""The CUDA block decoder's own source, compiled with g++ as a host
emulation of its warp, against the port's plain version on the CPU.

The kernel cannot run without a card, so this holds its logic here: the
device code of ``snappy_tpu_torch/csrc/decode_blocks.cu`` (everything
before its ``extern "C"`` launcher) is compiled unchanged but for one
textual substitution (its cuda_runtime include), with 32 ``std::thread``
lanes per block, a ``std::barrier`` for ``__syncwarp``, the warp's
shuffles and ballot through an exchange array between two such barriers,
its ``__shared__`` arrays as statics and the float intrinsics of its
remainder as their host operations. It is built for three row shapes, by the window and ring it is
compiled with: rows narrower than the ring (ring and window of 16 KiB, so
every row of the battery is staged once and its output fits the window),
rows wider than the ring (a ring of 64 bytes) and rows wider than the window
(a window of 256 bytes, flushed every 128). The rows at the window's and
ring's edges (``tools/profile_decode.window_rows``) also run at the
source's own window and ring.

Tolerance: exact. ``ok`` and ``out`` must be identical on every row, and
``total`` identical where ``ok``. Rows whose lengths do not fit the batch
(which the wrapper reads only for CPU tensors) must come back not ok and
all zero. Nothing may be written outside the rows.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import decode_torch
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import profile_decode

from torch_helpers import kernel_battery, native_body, odd_width_batch

OUT_SIZE = 8192
WIDE = 1 << 17
GUARD = 64  # canary bytes on each side of the output rows

PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
static std::barrier<>* g_bar;
static inline void __syncwarp() { g_bar->arrive_and_wait(); }
static inline float __fdividef(float a, float b) { return a / b; }
static inline uint32_t __float2uint_rz(float x) { return static_cast<uint32_t>(x); }
// The warp's shuffles and ballot through an exchange array between barriers.
static uint32_t g_xchg[32];
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int from) {
  g_xchg[threadIdx.x] = v;
  __syncwarp();
  const uint32_t r = g_xchg[from];
  __syncwarp();
  return r;
}
static inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d) {
  g_xchg[threadIdx.x] = v;
  __syncwarp();
  const uint32_t r = threadIdx.x >= d ? g_xchg[threadIdx.x - d] : v;
  __syncwarp();
  return r;
}
static inline unsigned __ballot_sync(unsigned, bool p) {
  g_xchg[threadIdx.x] = p;
  __syncwarp();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= g_xchg[i] << i;
  __syncwarp();
  return m;
}
"""

HARNESS = r"""
// Run the kernel over `rows` blocks, one block at a time, with 32 threads
// as the lanes of its warp.
extern "C" void emu_decode_blocks(const uint8_t* comp, const int32_t* clens,
                                  const int32_t* ulens, int64_t rows, int64_t row_c,
                                  int64_t out_size, uint8_t* out, uint8_t* ok,
                                  int32_t* total) {
  std::barrier<> bar(kWarp);
  g_bar = &bar;
  std::vector<std::thread> lanes;
  for (int l = 0; l < kWarp; ++l) {
    lanes.emplace_back([=, &bar] {
      threadIdx.x = l;
      for (int64_t r = 0; r < rows; ++r) {
        blockIdx.x = r;
        decode_blocks_kernel(comp, clens, ulens, row_c, out_size, out, ok, total);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : lanes) t.join();
}
"""

# (text in the kernel source, its host replacement)
SUBSTITUTIONS = [("#include <cuda_runtime.h>", "")]


def emulation_source(src: str | None = None) -> str:
    """The device part of a decoder source (default: this package's) with
    the prelude and harness above."""
    src = (CSRC / "decode_blocks.cu").read_text() if src is None else src
    src = src[: src.index('extern "C" {')]
    for old, new in SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return PRELUDE + src + HARNESS


def build_emulation(directory, source: str, defines=()) -> ctypes.CDLL:
    cpp, so = directory / "decode_blocks_host.cpp", directory / "decode_blocks_host.so"
    cpp.write_text(source)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared", "-Wall", *defines, str(cpp), "-o", str(so)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_decode_blocks.argtypes = [p, p, p, i64, i64, i64, p, p, p]
    lib.emu_decode_blocks.restype = None
    return lib


def run_emulation(lib, comp, clens, ulens, out_size):
    """(out, ok, total) of an emulation library on a batch; checks the
    guard zone around the output rows."""
    rows, row_c = comp.shape
    buf = np.full(rows * out_size + 2 * GUARD, 0xAB, np.uint8)
    ok = np.full(rows, 7, np.uint8)
    total = np.zeros(rows, np.int32)
    lib.emu_decode_blocks(
        comp.ctypes.data, clens.ctypes.data, ulens.ctypes.data, rows, row_c, out_size,
        buf.ctypes.data + GUARD, ok.ctypes.data, total.ctypes.data,
    )
    assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
    assert set(np.unique(ok)) <= {0, 1}
    return buf[GUARD:-GUARD].reshape(rows, out_size), ok.astype(bool), total


# Row shapes: (window, ring) the source is compiled with; None is its own.
SHAPE_BUILDS = {
    "rows-narrower-than-the-ring": (16384, 16384),
    "rows-wider-than-the-ring": (16384, 64),
    "rows-wider-than-the-window": (256, 64),
    "the-source's-window-and-ring": (None, None),
}
ROW_SHAPES = pytest.mark.parametrize("shape", list(SHAPE_BUILDS)[:3])


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """run(comp, clens, ulens, out_size, shape) on the emulation built for
    ``shape``; each build once."""
    libs = {}

    def run(comp, clens, ulens, out_size, shape):
        if shape not in libs:
            window, ring = SHAPE_BUILDS[shape]
            defines = [f"-DSNAPPY_K1_WINDOW={window}", f"-DSNAPPY_K1_RING={ring}"] if window else []
            libs[shape] = build_emulation(tmp_path_factory.mktemp("decode_blocks_host"), emulation_source(), defines)
        return run_emulation(libs[shape], comp, clens, ulens, out_size)

    return run


def _plain(comp, clens, ulens, out_size):
    return tuple(
        x.numpy()
        for x in decode_torch.decode_blocks(
            torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), out_size
        )
    )


def _assert_same(got, want):
    out, ok, total = got
    p_out, p_ok, p_total = want
    np.testing.assert_array_equal(ok, p_ok)
    np.testing.assert_array_equal(out, p_out)
    np.testing.assert_array_equal(total[ok], p_total[p_ok])


def aligned_batch(cases):
    """Rows of a width that is a multiple of 16, as the host drivers pack
    them, so that the ring is staged with 16-byte loads."""
    comp, clens, ulens = odd_width_batch(cases)
    wide = np.zeros((len(comp), -(-comp.shape[1] // 16) * 16), np.uint8)
    wide[:, : comp.shape[1]] = comp
    return wide, clens, ulens


@pytest.fixture(scope="module")
def battery():
    """The battery in rows of an odd width (bytes into the ring) at
    OUT_SIZE, and in rows of a multiple of 16 (16-byte loads) at an output
    size that leaves every row but the first unaligned (byte stores out)."""
    cases = kernel_battery(OUT_SIZE)
    batches = ((odd_width_batch(cases), OUT_SIZE), (aligned_batch(cases), OUT_SIZE + 3))
    return [(args, out_size, _plain(*args, out_size)) for args, out_size in batches]


@ROW_SHAPES
def test_kernel_matches_plain_version(emu, battery, shape):
    for (comp, clens, ulens), out_size, want in battery:
        assert 0 < want[1].sum() < len(want[1])
        _assert_same(emu(comp, clens, ulens, out_size, shape), want)


@pytest.mark.parametrize("shape", list(SHAPE_BUILDS))
def test_kernel_matches_plain_version_at_the_window_edges(emu, shape):
    """Copies from offsets around the window and its near reach across
    flushes, overlapping copies with offsets 1-33 and lengths up to 64,
    literals around the ring's size, a 128 KiB segment and text across
    several flushes, at 128 KiB rows: the plain version's bytes, which are
    the rows' own."""
    window, ring = SHAPE_BUILDS[shape]
    rows = profile_decode.window_rows(window, ring)
    comp, clens, ulens = aligned_batch([(body, len(raw)) for body, raw in rows.values()])
    want = _plain(comp, clens, ulens, WIDE)
    assert want[1].all()
    for i, (_, raw) in enumerate(rows.values()):
        assert want[0][i, : len(raw)].tobytes() == raw
    _assert_same(emu(comp, clens, ulens, WIDE, shape), want)


@pytest.mark.parametrize("shape", list(SHAPE_BUILDS))
@pytest.mark.parametrize("width", ["aligned", "odd"])
def test_kernel_matches_plain_version_at_the_chase_edges(emu, shape, width):
    """Rows at the edges of the chase's step tables over the build's ring
    (``tools/profile_decode.chase_rows``): a literal with a length trailer
    as every tag of a batch, tags across the ring's end at every offset of
    their 5 bytes, short literals to the ring's end and a byte past it, 32
    and 33 tags to the ring's end, overlapping copies after full batches,
    and a last tag of two bytes; in rows staged with 16-byte loads and rows
    of an odd width. The plain version's bytes, which are the rows' own."""
    _, ring = SHAPE_BUILDS[shape]
    rows = profile_decode.chase_rows(ring)
    batch = aligned_batch if width == "aligned" else odd_width_batch
    comp, clens, ulens = batch([(body, len(raw)) for body, raw in rows.values()])
    want = _plain(comp, clens, ulens, WIDE)
    assert want[1].all()
    for i, (_, raw) in enumerate(rows.values()):
        assert want[0][i, : len(raw)].tobytes() == raw
    _assert_same(emu(comp, clens, ulens, WIDE, shape), want)


@ROW_SHAPES
def test_kernel_refuses_lengths_outside_the_batch(emu, shape):
    """Lengths the CUDA wrapper does not read on the host: the kernel's own
    guard turns such a row into a not-ok, all-zero row; the rows around it
    decode as usual."""
    good = native_body(b"hello world " * 40)
    width = len(good) + 4 + 3
    bad = [(width - 3, 480), (-1, 480), (len(good), OUT_SIZE + 1), (len(good), -5)]
    rows = [(len(good), 480)] + bad + [(len(good), 480)]
    comp = np.zeros((len(rows), width), np.uint8)
    comp[:, : len(good)] = np.frombuffer(good, np.uint8)
    clens = np.array([c for c, _ in rows], np.int32)
    ulens = np.array([u for _, u in rows], np.int32)
    out, ok, total = emu(comp, clens, ulens, OUT_SIZE, shape)
    np.testing.assert_array_equal(ok, [True, False, False, False, False, True])
    assert not out[1:-1].any()
    for r in (0, -1):
        assert total[r] == 480 and out[r, :480].tobytes() == b"hello world " * 40 and not out[r, 480:].any()


def _long_literal(n: int) -> bytes:
    return bytes([62 << 2]) + (n - 1).to_bytes(3, "little") + bytes(range(256)) * (n // 256) + bytes(n % 256)


@ROW_SHAPES
@pytest.mark.parametrize("overrun", ["literal", "copy", "copies"])
def test_kernel_writes_nothing_past_the_row(emu, shape, overrun):
    """A block that claims more output than its row holds: not ok, all zero,
    and no byte written past the row (the emulation checks a guard zone).
    "copies" runs past the row by more than a window, in short copies that
    the walk takes in batches."""
    if overrun == "literal":
        body = _long_literal(OUT_SIZE + 40)
    elif overrun == "copy":
        body = _long_literal(OUT_SIZE - 8) + bytes([0x02 | (63 << 2), 64, 0]) * 2
    else:
        body = bytes([3 << 2]) + b"abcd" + bytes([0x02 | (63 << 2), 1, 0]) * ((OUT_SIZE + 20000) // 64)
    comp = np.zeros((1, len(body) + 4), np.uint8)
    comp[0, : len(body)] = np.frombuffer(body, np.uint8)
    clens = np.array([len(body)], np.int32)
    out, ok, _ = emu(comp, clens, np.array([OUT_SIZE], np.int32), OUT_SIZE, shape)
    assert not ok[0] and not out.any()


@ROW_SHAPES
def test_kernel_refuses_a_literal_past_the_stream(emu, shape):
    """A short literal, after a copy, whose last 1-3 bytes lie past clen (in
    the row's padding): not ok and all zero, as in the plain version, though
    the output length would match."""
    rows = []
    for short in (1, 2, 3):
        body = bytes([2 << 2]) + b"abc" + bytes([0x02 | (3 << 2), 3, 0]) + bytes([4 << 2]) + b"vwxyz"[: 5 - short]
        rows.append((body, 3 + 4 + 5))
    comp, clens, ulens = aligned_batch(rows)
    want = _plain(comp, clens, ulens, OUT_SIZE)
    assert not want[1].any()
    _assert_same(emu(comp, clens, ulens, OUT_SIZE, shape), want)
