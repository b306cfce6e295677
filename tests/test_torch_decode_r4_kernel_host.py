"""K3's CUDA source, compiled with g++ as a host emulation of its thread
block, against the port's plain K3 (``decode_torch.decode_blocks_r4``).

The kernel cannot run without a card, so this holds its logic here: the
device code of ``snappy_tpu_torch/csrc/decode_blocks_r4.cu`` (everything
before its ``extern "C"`` launcher) is compiled unchanged but for two
textual substitutions, with one ``std::thread`` per thread of a block of 64
(two warps; the thread count is a macro, the card runs 256), a
``std::barrier`` for ``__syncthreads`` and one per warp for ``__syncwarp``,
and a static buffer for its shared memory. All three instantiations run:
row and output staged in shared memory, the row alone, and neither. The
launcher's choice between them is checked on the card by ``chip_smoke.py``.

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

from torch_helpers import copy2, kernel_battery, lit, native_body, odd_width_batch, synthetic_cases

OUT_SIZE = 8192
WIDE = 1 << 17
GUARD = 64  # canary bytes on each side of the output rows

_PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define SNAPPY_R4_THREADS 64
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
constexpr int kEmuWarps = SNAPPY_R4_THREADS / 32;
static std::barrier<>* g_block_bar;
static std::barrier<>* g_warp_bar[kEmuWarps];
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
constexpr int64_t kSmemBytes = 1 << 20;
alignas(16) static uint8_t g_smem[kSmemBytes];
"""

_HARNESS = r"""
// Run the kernel over `rows` blocks, one block at a time, with kThreads
// std::threads as its threads. mode 0: row and output in shared memory,
// 1: the row only, 2: neither. Returns 0, or 1 if the shared memory does
// not fit the emulated buffer.
extern "C" int emu_decode_blocks_r4(const uint8_t* comp, const int32_t* clens,
                                    const int32_t* ulens, int64_t rows, int64_t row_c,
                                    int64_t out_size, uint8_t* out, uint8_t* ok,
                                    int32_t* total, int mode) {
  if (kHeadBytes + round16(row_c) + round16(out_size) > kSmemBytes) return 1;
  std::barrier<> block_bar(kThreads);
  g_block_bar = &block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; w < kEmuWarps; ++w) {
    warp_bars.emplace_back(new std::barrier<>(kWarp));
    g_warp_bar[w] = warp_bars.back().get();
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([=, &block_bar] {
      threadIdx.x = t;
      for (int64_t r = 0; r < rows; ++r) {
        blockIdx.x = r;
        if (mode == 0)
          decode_blocks_r4_kernel<true, true>(comp, clens, ulens, row_c, out_size, out, ok, total);
        else if (mode == 1)
          decode_blocks_r4_kernel<true, false>(comp, clens, ulens, row_c, out_size, out, ok, total);
        else
          decode_blocks_r4_kernel<false, false>(comp, clens, ulens, row_c, out_size, out, ok, total);
        block_bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}
"""

# (text in the kernel source, its host replacement)
_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;"),
]


def _emulation_source() -> str:
    src = (CSRC / "decode_blocks_r4.cu").read_text()
    src = src[: src.index('extern "C" {')]
    for old, new in _SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return _PRELUDE + src + _HARNESS


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_blocks_r4_host")
    cpp, so = d / "decode_blocks_r4_host.cpp", d / "decode_blocks_r4_host.so"
    cpp.write_text(_emulation_source())
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared", "-Wall", str(cpp), "-o", str(so)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_decode_blocks_r4.argtypes = [p, p, p, i64, i64, i64, p, p, p, ctypes.c_int]
    lib.emu_decode_blocks_r4.restype = ctypes.c_int

    def run(comp, clens, ulens, out_size, mode):
        rows, row_c = comp.shape
        buf = np.full(rows * out_size + 2 * GUARD, 0xAB, np.uint8)
        ok = np.full(rows, 7, np.uint8)
        total = np.zeros(rows, np.int32)
        rc = lib.emu_decode_blocks_r4(
            comp.ctypes.data, clens.ctypes.data, ulens.ctypes.data, rows, row_c, out_size,
            buf.ctypes.data + GUARD, ok.ctypes.data, total.ctypes.data, mode,
        )
        assert rc == 0
        assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
        assert set(np.unique(ok)) <= {0, 1}
        return buf[GUARD:-GUARD].reshape(rows, out_size), ok.astype(bool), total

    return run


def _plain(comp, clens, ulens, out_size):
    return tuple(
        x.numpy()
        for x in decode_torch.decode_blocks_r4(
            torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), out_size
        )
    )


def _assert_same(got, want):
    out, ok, total = got
    p_out, p_ok, p_total = want
    np.testing.assert_array_equal(ok, p_ok)
    np.testing.assert_array_equal(out, p_out)
    np.testing.assert_array_equal(total[ok], p_total[p_ok])


def _wide_battery():
    """(tag stream, ulen) rows at 128 KiB of output: K3's envelope at its
    edges, a literal longer than a chunk's worth of records, runs of
    records past one chunk, and the synthetic battery (copy folds)."""
    rng = np.random.default_rng(5)
    big = rng.integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    head = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big + lit(b"0123456789")
    big1 = big + b"!"
    rows = [
        (head + bytes([0x03 | (63 << 2)]) + (65536).to_bytes(4, "little"), len(big) + 10 + 64),
        (head + copy2(64, 65535), len(big) + 10 + 64),
        (head + copy2(64, 65535) * 3 + copy2(5, 65535), len(big) + 10 + 197),
        (bytes([62 << 2]) + (len(big1) - 1).to_bytes(3, "little") + big1, len(big1)),
        (lit(b"xy") + copy2(64, 2) * 1500 + copy2(9, 1), 2 + 64 * 1500 + 9),  # > 1024 records
        (lit(b"a") + copy2(64, 1) * 2047, 1 + 64 * 2047),  # exactly one chunk after folding
        (native_body(bytes(rng.integers(0, 4, 100_000, dtype=np.uint8))), 100_000),
    ]
    rows += [(body, u) for _, body, u, _ in synthetic_cases()]
    return rows


STAGING = pytest.mark.parametrize("mode", [0, 1, 2], ids=["row-and-output-staged", "row-staged", "device-memory"])


@STAGING
def test_kernel_matches_plain_version(emu, mode):
    comp, clens, ulens = odd_width_batch(kernel_battery(OUT_SIZE))
    want = _plain(comp, clens, ulens, OUT_SIZE)
    assert 0 < want[1].sum() < len(want[1])
    _assert_same(emu(comp, clens, ulens, OUT_SIZE, mode), want)


@STAGING
def test_kernel_matches_plain_version_wide(emu, mode):
    comp, clens, ulens = odd_width_batch(_wide_battery())
    want = _plain(comp, clens, ulens, WIDE)
    assert want[1].tolist()[:7] == [False, True, True, False, True, True, True]
    _assert_same(emu(comp, clens, ulens, WIDE, mode), want)


@STAGING
def test_kernel_refuses_lengths_outside_the_batch(emu, mode):
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
    out, ok, total = emu(comp, clens, ulens, OUT_SIZE, mode)
    np.testing.assert_array_equal(ok, [True, False, False, False, False, True])
    assert not out[1:-1].any()
    for r in (0, -1):
        assert total[r] == 480 and out[r, :480].tobytes() == b"hello world " * 40 and not out[r, 480:].any()


@STAGING
@pytest.mark.parametrize("overrun", ["literal", "copy"])
def test_kernel_writes_nothing_past_the_row(emu, mode, overrun):
    """A block that claims more output than its row holds: not ok, all zero,
    and no byte written past the row (the emulation checks a guard zone)."""
    filler = bytes(range(256)) * 32
    if overrun == "literal":
        body = bytes([61 << 2]) + (OUT_SIZE + 39).to_bytes(2, "little") + (filler * 2)[: OUT_SIZE + 40]
    else:
        body = bytes([61 << 2]) + (OUT_SIZE - 9).to_bytes(2, "little") + filler[: OUT_SIZE - 8] + copy2(64, 64) * 2
    comp = np.zeros((1, len(body) + 4), np.uint8)
    comp[0, : len(body)] = np.frombuffer(body, np.uint8)
    out, ok, _ = emu(comp, np.array([len(body)], np.int32), np.array([OUT_SIZE], np.int32), OUT_SIZE, mode)
    assert not ok[0] and not out.any()
