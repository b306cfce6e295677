"""The CUDA block decoder's own source, compiled with g++ as a host
emulation of its warp, against the port's plain version on the CPU.

The kernel cannot run without a card, so this holds its logic here: the
device code of ``snappy_tpu_torch/csrc/decode_blocks.cu`` (everything
before its ``extern "C"`` launcher) is compiled unchanged but for two
textual substitutions, with 32 ``std::thread`` lanes per block, a
``std::barrier`` for ``__syncwarp`` and a static buffer for its shared
memory. Both instantiations run: the one that stages the row in shared
memory, and the one that reads device memory (rows wider than shared
memory). The launcher's choice between them is checked on the card by
``chip_smoke.py``.

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

from torch_helpers import kernel_battery, native_body, odd_width_batch

OUT_SIZE = 8192
GUARD = 64  # canary bytes on each side of the output rows

_PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
static std::barrier<>* g_bar;
static inline void __syncwarp() { g_bar->arrive_and_wait(); }
constexpr int64_t kSmemBytes = 1 << 20;
alignas(16) static uint8_t g_smem[kSmemBytes];
"""

_HARNESS = r"""
// Run the kernel over `rows` blocks, one block at a time, with 32 threads
// as the lanes of its warp. Returns 0, or 1 if a row is too wide for the
// emulated shared memory.
extern "C" int emu_decode_blocks(const uint8_t* comp, const int32_t* clens,
                                 const int32_t* ulens, int64_t rows, int64_t row_c,
                                 int64_t out_size, uint8_t* out, uint8_t* ok,
                                 int32_t* total, int staged) {
  if (staged && row_c > kSmemBytes) return 1;
  std::barrier<> bar(kWarp);
  g_bar = &bar;
  std::vector<std::thread> lanes;
  for (int l = 0; l < kWarp; ++l) {
    lanes.emplace_back([=, &bar] {
      threadIdx.x = l;
      for (int64_t r = 0; r < rows; ++r) {
        blockIdx.x = r;
        if (staged)
          decode_blocks_kernel<true>(comp, clens, ulens, row_c, out_size, out, ok, total);
        else
          decode_blocks_kernel<false>(comp, clens, ulens, row_c, out_size, out, ok, total);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : lanes) t.join();
  return 0;
}
"""

# (text in the kernel source, its host replacement)
_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;"),
]


def _emulation_source() -> str:
    src = (CSRC / "decode_blocks.cu").read_text()
    cut = src.index('extern "C" {')
    src = src[:cut]
    for old, new in _SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return _PRELUDE + src + _HARNESS


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    d = tmp_path_factory.mktemp("decode_blocks_host")
    cpp, so = d / "decode_blocks_host.cpp", d / "decode_blocks_host.so"
    cpp.write_text(_emulation_source())
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared", "-Wall", str(cpp), "-o", str(so)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_decode_blocks.argtypes = [p, p, p, i64, i64, i64, p, p, p, ctypes.c_int]
    lib.emu_decode_blocks.restype = ctypes.c_int

    def run(comp, clens, ulens, out_size, staged):
        rows, row_c = comp.shape
        buf = np.full(rows * out_size + 2 * GUARD, 0xAB, np.uint8)
        ok = np.full(rows, 7, np.uint8)
        total = np.zeros(rows, np.int32)
        rc = lib.emu_decode_blocks(
            comp.ctypes.data, clens.ctypes.data, ulens.ctypes.data, rows, row_c, out_size,
            buf.ctypes.data + GUARD, ok.ctypes.data, total.ctypes.data, int(staged),
        )
        assert rc == 0
        assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
        assert set(np.unique(ok)) <= {0, 1}
        return buf[GUARD:-GUARD].reshape(rows, out_size), ok.astype(bool), total

    return run


STAGING = pytest.mark.parametrize("staged", [True, False], ids=["shared-memory", "device-memory"])


@STAGING
def test_kernel_matches_plain_version(emu, staged):
    comp, clens, ulens = odd_width_batch(kernel_battery(OUT_SIZE))
    p_out, p_ok, p_total = (
        x.numpy()
        for x in decode_torch.decode_blocks(
            torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), OUT_SIZE
        )
    )
    out, ok, total = emu(comp, clens, ulens, OUT_SIZE, staged)
    assert 0 < p_ok.sum() < len(p_ok)
    np.testing.assert_array_equal(ok, p_ok)
    np.testing.assert_array_equal(out, p_out)
    np.testing.assert_array_equal(total[ok], p_total[p_ok])


@STAGING
def test_kernel_refuses_lengths_outside_the_batch(emu, staged):
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
    out, ok, total = emu(comp, clens, ulens, OUT_SIZE, staged)
    np.testing.assert_array_equal(ok, [True, False, False, False, False, True])
    assert not out[1:-1].any()
    for r in (0, -1):
        assert total[r] == 480 and out[r, :480].tobytes() == b"hello world " * 40 and not out[r, 480:].any()


def _long_literal(n: int) -> bytes:
    return bytes([62 << 2]) + (n - 1).to_bytes(3, "little") + bytes(range(256)) * (n // 256) + bytes(n % 256)


@STAGING
@pytest.mark.parametrize("overrun", ["literal", "copy"])
def test_kernel_writes_nothing_past_the_row(emu, staged, overrun):
    """A block that claims more output than its row holds: not ok, all zero,
    and no byte written past the row (the emulation checks a guard zone)."""
    if overrun == "literal":
        body = _long_literal(OUT_SIZE + 40)
    else:
        body = _long_literal(OUT_SIZE - 8) + bytes([0x02 | (63 << 2), 64, 0]) * 2
    comp = np.zeros((1, len(body) + 4), np.uint8)
    comp[0, : len(body)] = np.frombuffer(body, np.uint8)
    clens = np.array([len(body)], np.int32)
    out, ok, _ = emu(comp, clens, np.array([OUT_SIZE], np.int32), OUT_SIZE, staged)
    assert not ok[0] and not out.any()
