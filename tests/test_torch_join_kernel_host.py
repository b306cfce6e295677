"""K5 (``csrc/join_streams.cu``) and K2's ragged entry
(``csrc/encode_blocks.cu`` with a fragment table) compiled with g++ as host
emulations of their thread blocks, against their plain versions on the CPU.

The kernels cannot run without a card, so this holds their logic here, as
``test_torch_encode_kernel_host.py`` does for K2's fixed rows (whose
prelude and substitutions K2's ragged entry reuses, a block of 64 threads):
the device code of each source, everything before its ``extern "C"``
launcher, compiled unchanged but for its cuda_runtime include, with a
``std::thread`` a thread of the block, a ``std::barrier`` for
``__syncthreads`` and its ``__shared__`` arrays as statics. Blocks run one
at a time in order. K5 is built at its source's 16 items a block (with 32
threads: the reduction halves the block whatever its size) and at 3 items
and 8 threads, so that pages and their fragments fall across many blocks.

K2's ragged rows are fragments of one buffer, at 8-byte-aligned starts (its
word staging) and at odd ones (its byte staging), at both variants' widths,
empty and full, beside fragments that do not lie in the buffer or are too
long (refused: olens -1, all zero). K5 runs on the fragment table and the
plain K2's rows of pages at any offset (an empty page, a refused one), and
on crafted tables: refused rows, pages with no fragment, and a ``cap`` too
small for the last pages.

Tolerance: exact. Every output byte, ``olens``, ``cstarts`` and ``clens``
equal the plain version's; nothing is written outside the outputs.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import cuda_encode, cuda_join
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT
from snappy_tpu_torch.ops.kernels import CSRC

from conftest import read_testdata
from test_torch_encode_kernel_host import _emulation_source as k2_source

GUARD = 64

K2_RAGGED = r"""
template <int kBits>
static int emu_run_ragged(const uint8_t* data, int64_t data_len, const int64_t* fstarts, const int32_t* flens,
                          int64_t rows, int64_t row_w, int64_t out_w, int min_profit, uint8_t* out,
                          int32_t* olens) {
  constexpr int kThreads = Shape<kBits>::kThreads;
  if (Shape<kBits>::kSmemBytes > int64_t(sizeof(g_smem))) return 1;
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
        encode_blocks_kernel<kBits>(data, flens, row_w, out_w, min_profit, out, olens, fstarts, data_len);
        block_bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

// The ragged launcher's work: fragments of at most max_block bytes, the
// variant a row of max_block + 8 bytes picks.
extern "C" int emu_encode_fragments(const uint8_t* data, int64_t data_len, const int64_t* fstarts,
                                    const int32_t* flens, int64_t rows, int64_t max_block, int64_t out_w,
                                    int min_profit, uint8_t* out, int32_t* olens) {
  const int64_t row_w = max_block + kEncPad;
  return block_bits_for(row_w) == 15
             ? emu_run_ragged<15>(data, data_len, fstarts, flens, rows, row_w, out_w, min_profit, out, olens)
             : emu_run_ragged<16>(data, data_len, fstarts, flens, rows, row_w, out_w, min_profit, out, olens);
}
"""

K5_PRELUDE = r"""
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
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
static std::barrier<>* g_block_bar;
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
"""

K5_HARNESS = r"""
// The launcher's grid, one block after another.
extern "C" void emu_join_streams(const uint8_t* frags, int64_t frag_w, const int32_t* olens, const int32_t* frow,
                                 const int64_t* ffirst, const int32_t* fcount, const int32_t* ulens, int64_t n,
                                 int64_t frag_cap, uint8_t* comp, int64_t cap, int64_t* cstarts, int32_t* clens) {
  if (n <= 0) return;
  const int64_t blocks = (n + frag_cap + kItems - 1) / kItems;
  std::barrier<> bar(kThreads);
  g_block_bar = &bar;
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([=, &bar] {
      threadIdx.x = t;
      for (int64_t b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        join_streams_kernel(frags, frag_w, olens, frow, ffirst, fcount, ulens, n, comp, cap, cstarts, clens);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
}
"""


def _compile(d, name: str, source: str, defines=()) -> ctypes.CDLL:
    cpp, so = d / f"{name}.cpp", d / f"{name}.so"
    cpp.write_text(source)
    proc = subprocess.run(["g++", "-std=c++20", "-O2", "-fno-strict-aliasing", "-pthread", "-fPIC", "-shared", "-Wall",
                           *defines, str(cpp), "-o", str(so)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _k5_source() -> str:
    src = (CSRC / "join_streams.cu").read_text()
    src = src[: src.index('extern "C" {')]
    assert src.count("#include <cuda_runtime.h>") == 1, "the kernel source no longer includes cuda_runtime.h"
    return K5_PRELUDE + src.replace("#include <cuda_runtime.h>", "") + K5_HARNESS


@pytest.fixture(scope="module")
def k2(tmp_path_factory):
    lib = _compile(tmp_path_factory.mktemp("k2_ragged"), "k2_ragged", k2_source() + K2_RAGGED)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_encode_fragments.argtypes = [p, i64, p, p, i64, i64, i64, ctypes.c_int, p, p]
    lib.emu_encode_fragments.restype = ctypes.c_int

    def run(data, fstarts, flens, max_block, min_profit=2):
        rows = len(fstarts)
        buf = np.full(rows * BLOCK_MAX_OUT + 2 * GUARD, 0xAB, np.uint8)
        olens = np.full(rows, 7, np.int32)
        rc = lib.emu_encode_fragments(data.ctypes.data, len(data), fstarts.ctypes.data, flens.ctypes.data, rows,
                                      max_block, BLOCK_MAX_OUT, min_profit, buf.ctypes.data + GUARD,
                                      olens.ctypes.data)
        assert rc == 0
        assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
        return buf[GUARD:-GUARD].reshape(rows, BLOCK_MAX_OUT), olens

    return run


K5_BUILDS = {"source": ["-DSNAPPY_K5_THREADS=32"], "3-items": ["-DSNAPPY_K5_THREADS=8", "-DSNAPPY_K5_ITEMS=3"]}


@pytest.fixture(scope="module", params=list(K5_BUILDS))
def k5(request, tmp_path_factory):
    lib = _compile(tmp_path_factory.mktemp("k5"), "k5", _k5_source(), K5_BUILDS[request.param])
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_join_streams.argtypes = [p, i64, p, p, p, p, p, i64, i64, p, i64, p, p]
    lib.emu_join_streams.restype = None

    def run(frags, olens, frow, ffirst, fcount, ulens, cap):
        n = len(ffirst)
        comp = np.full(cap + 2 * GUARD, 0xAB, np.uint8)
        cstarts, clens = np.full(n, -7, np.int64), np.full(n, -7, np.int32)
        lib.emu_join_streams(frags.ctypes.data, frags.shape[1], olens.ctypes.data, frow.ctypes.data,
                             ffirst.ctypes.data, fcount.ctypes.data, ulens.ctypes.data, n, len(frow),
                             comp.ctypes.data + GUARD, cap, cstarts.ctypes.data, clens.ctypes.data)
        assert (comp[:GUARD] == 0xAB).all() and (comp[-GUARD:] == 0xAB).all(), "wrote outside comp"
        return comp[GUARD:-GUARD], cstarts, clens

    return run


def _plain_join(frags, olens, frow, ffirst, fcount, ulens, cap):
    n = len(ffirst)
    comp = torch.full((cap,), 0xAB, dtype=torch.uint8)
    cstarts, clens = torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.int32)
    cuda_join.join_streams_plain(*(torch.from_numpy(a) for a in (frags, olens, frow, ffirst, fcount, ulens)),
                                 comp, cstarts, clens)
    return comp.numpy(), cstarts.numpy(), clens.numpy()


def _buffer():
    """Corpus text and lineitem-like int64 bytes, 1 MiB; fragments cut from it."""
    text = read_testdata("alice29.txt") + read_testdata("html")
    ints = (np.arange(40000, dtype=np.int64) * 7 + 75_000_000).view(np.uint8).tobytes()
    return np.frombuffer((text + ints) * 2, np.uint8)[: 1 << 20].copy()


def test_k2_ragged_rows_match_the_plain_version(k2):
    """Fragments read in place, aligned and not, empty to full, at both
    widths: the bytes and lengths of the plain version's fixed rows; those
    outside the buffer or too long refused, all zero."""
    data = _buffer()
    for max_block in (1 << 15, 1 << 16):
        cases = [(0, max_block), (8, 1000), (3, 0), (4097, 1), (123_457, 20_000), (len(data) - max_block, max_block),
                 (40_001, max_block // 2 + 7), (65_541, 3)]
        bad = [(len(data) - 10, 11), (-1, 5), (0, max_block + 1), (100, -1)]
        fstarts = np.array([s for s, _ in cases + bad], np.int64)
        flens = np.array([n for _, n in cases + bad], np.int32)
        out, olens = k2(data, fstarts, flens, max_block)
        good = len(cases)
        p_out, p_olens = cuda_encode.encode_fragments_plain(
            torch.from_numpy(data), torch.from_numpy(fstarts[:good]), torch.from_numpy(flens[:good]), 2, max_block,
            torch.empty((good, BLOCK_MAX_OUT), dtype=torch.uint8), torch.empty(good, dtype=torch.int32))
        np.testing.assert_array_equal(olens[:good], p_olens.numpy())
        np.testing.assert_array_equal(out[:good], p_out.numpy())
        assert (olens[good:] == -1).all() and not out[good:].any(), max_block


def _table(data, pages):
    """The fragment table and the plain K2's rows of ``pages`` (start,
    length) of ``data``, as compress_streams builds them."""
    starts = torch.tensor([s for s, _ in pages], dtype=torch.int64)
    ulens = torch.tensor([n for _, n in pages], dtype=torch.int32)
    t = cuda_join.fragment_table(starts, ulens, len(data))
    wide, narrow = t.wide, t.narrow
    rows = len(wide[0]) + len(narrow[0])
    frags = torch.zeros((rows, BLOCK_MAX_OUT), dtype=torch.uint8)
    olens = torch.zeros(rows, dtype=torch.int32)
    src = torch.from_numpy(data)
    cuda_encode.encode_fragments_plain(src, *wide, 2, 1 << 16, frags[: len(wide[0])], olens[: len(wide[0])])
    cuda_encode.encode_fragments_plain(src, *narrow, 2, 1 << 15, frags[len(wide[0]) :], olens[len(wide[0]) :])
    return (frags.numpy(), olens.numpy(), t.frow.numpy(), t.ffirst.numpy(), t.fcount.numpy(), ulens.numpy()), t


def test_k5_joins_pages_as_the_plain_version(k5):
    """Pages at any offset of one buffer, an empty one and a refused one:
    K5's streams, starts and lengths equal the plain join's, and each
    stream is the page's header and its fragments' rows."""
    data = _buffer()[: 300_000]
    pages = [(0, 70_000), (70_001, 0), (70_005, 65_536), (135_541, 65_537), (240_000, 59_990), (299_990, 11),
             (201_078, 3), (299_999, 1)]
    args, t = _table(data, pages)
    cap = cuda_join.stream_bound(len(pages), len(data))
    got = k5(*args, cap)
    want = _plain_join(*args, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    comp, cstarts, clens = got
    assert clens.tolist()[5] == -1 and clens.tolist()[1] == 1 and (clens[[0, 2, 3, 4, 6, 7]] > 0).all()
    ends = cstarts + np.maximum(clens, 0)
    assert (cstarts[1:] == ends[:-1]).all(), "the streams lie end to end"


def test_k5_on_crafted_tables(k5):
    """Rows K2 refused, pages with no fragment, a refused page, and a cap
    that cuts the last pages: the plain join's bytes, starts and lengths;
    a page refused for its row keeps its fragments' place."""
    rng = np.random.default_rng(26)
    frags = rng.integers(0, 256, (12, 300), dtype=np.uint8)
    olens = np.array([10, 0, 300, 7, -1, 5, 1, 250, 3, 0, 0, 0], np.int32)
    fcount = np.array([2, 0, -1, 3, 1, 0, 2, 1, 1], np.int32)
    ffirst = (np.cumsum(np.maximum(fcount, 0)) - np.maximum(fcount, 0)).astype(np.int64)
    ulens = np.array([70_000, 0, 5, 150_000, 3, 0, 129, 2_000_000, 9], np.int32)
    frow = np.array([0, 2, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11][::-1], np.int32)
    for cap in (1000, 600, 300, 0):
        got = k5(frags, olens, frow, ffirst, fcount, ulens, cap)
        want = _plain_join(frags, olens, frow, ffirst, fcount, ulens, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"cap {cap}")
    assert (want[2] < 0).sum() >= 3
