"""The CUDA block encoder's own source, compiled with g++ as a host
emulation of its thread block, against the port's plain version on the CPU.

The kernel cannot run without a card, so this holds its logic here: the
device code of ``snappy_tpu_torch/csrc/encode_blocks.cu`` (everything before
its ``extern "C"`` launcher) is compiled unchanged but for two textual
substitutions, with one ``std::thread`` per thread of a block of 64 (the
kernel's thread count is a macro; the card runs 1024), a ``std::barrier``
for ``__syncthreads`` and one per warp for ``__syncwarp``, the warp vote
``__match_any_sync`` and the shuffles through a per-warp exchange array,
and a static buffer for its shared memory. The harness runs the variant
the launcher picks for the batch's row width (the source's own
``block_bits_for``), so the tests run at both widths the cells use: 32 KiB
rows (the 32 KiB layout, 13 hash bits, a chase chunk of its own) and 64 KiB
rows.

Tolerance: exact. ``out`` and ``olens`` must be identical on every row.
Rows whose ``blen`` does not fit the batch (which the wrapper reads only
for CPU tensors) must come back with ``olens = -1`` and all zero. Nothing
may be written outside the output rows.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import encode_torch
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT, ENC_PAD
from snappy_tpu_torch.ops.kernels import CSRC

from snappy_tpu_torch.tools.profile_encode import HASH_MUL, chase_rows, collision_block, hash_bits, record_chunk

from conftest import read_testdata
from torch_helpers import plain_takes

GUARD = 64  # canary bytes on each side of the output rows
# The row widths of the encoder's two variants: 32 KiB and 64 KiB blocks.
WIDTHS = {15: 32768 + ENC_PAD, 16: 65536 + ENC_PAD}


def _by_width(cases):
    """pytest params of (bits, *case) for each width and each of its
    ``cases(bits)``; a 32 KiB case's id starts with ``w32k``, a 64 KiB
    case's is the case's own."""
    return [pytest.param(bits, *case, id="-".join(["w32k"] * (bits == 15) + [str(c) for c in case]))
            for bits in WIDTHS for case in cases(bits)]

_PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>
#define SNAPPY_ENC_THREADS 64
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
constexpr int kEmuWarps = SNAPPY_ENC_THREADS / 32;
static std::barrier<>* g_block_bar;
static std::barrier<>* g_warp_bar[kEmuWarps];
static uint32_t g_xchg[kEmuWarps][32];
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
// Every lane of the warp posts v; the result has bit i set where lane i's
// value passes `pick`.
template <class F>
static inline uint32_t emu_vote(uint32_t v, F pick) {
  const int64_t w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncwarp();
  g_xchg[w][l] = v;
  __syncwarp();
  uint32_t m = 0;
  for (int i = 0; i < 32; ++i) m |= pick(g_xchg[w][i]) ? (1u << i) : 0u;
  return m;
}
static inline uint32_t __match_any_sync(unsigned, uint32_t v) {
  return emu_vote(v, [v](uint32_t x) { return x == v; });
}
static inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int mask) {
  const int64_t w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncwarp();
  g_xchg[w][l] = v;
  __syncwarp();
  return g_xchg[w][l ^ mask];
}
static inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int delta) {
  const int64_t w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncwarp();
  g_xchg[w][l] = v;
  __syncwarp();
  return l >= delta ? g_xchg[w][l - delta] : v;
}
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const int64_t w = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncwarp();
  g_xchg[w][l] = v;
  __syncwarp();
  return g_xchg[w][src];
}
static inline int __clz(int x) { return x ? __builtin_clz(unsigned(x)) : 32; }
static inline int __ffs(int x) { return __builtin_ffs(x); }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return uint32_t(((uint64_t(hi) << 32) | lo) >> (s & 31));
}
alignas(16) static uint8_t g_smem[1 << 18];
"""

_HARNESS = r"""
// Run the variant's kernel over `rows` blocks, one block at a time, with
// its kThreads std::threads as its threads. Returns 0, or 1 if the shared
// memory does not fit the emulated buffer.
template <int kBits>
static int emu_run(const uint8_t* blocks, const int32_t* blens, int64_t rows, int64_t row_w,
                   int64_t out_w, int min_profit, uint8_t* out, int32_t* olens) {
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
        encode_blocks_kernel<kBits>(blocks, blens, row_w, out_w, min_profit, out, olens);
        block_bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

// The launcher's choice for rows of row_w bytes, run as above.
extern "C" int emu_encode_blocks(const uint8_t* blocks, const int32_t* blens, int64_t rows,
                                 int64_t row_w, int64_t out_w, int min_profit, uint8_t* out,
                                 int32_t* olens) {
  return block_bits_for(row_w) == 15 ? emu_run<15>(blocks, blens, rows, row_w, out_w, min_profit, out, olens)
                                     : emu_run<16>(blocks, blens, rows, row_w, out_w, min_profit, out, olens);
}

// The variant the launcher picks for rows of row_w bytes, and a variant's
// shared memory a block and records a chunk.
extern "C" int emu_block_bits(int64_t row_w) { return block_bits_for(row_w); }
extern "C" int64_t emu_smem_bytes(int bits) { return bits == 15 ? Shape<15>::kSmemBytes : Shape<16>::kSmemBytes; }
extern "C" int emu_chunk(int bits) { return bits == 15 ? Shape<15>::kChunk : Shape<16>::kChunk; }

// The chase's extension of a match capped at kMCap bytes, on its own.
extern "C" uint32_t emu_extend(const uint8_t* row, uint32_t a, uint32_t b, uint32_t limit) {
  return extend(row, a, b, limit);
}
"""

# (text in the kernel source, its host replacement)
_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;"),
]


def _emulation_source(src: str | None = None) -> str:
    src = (CSRC / "encode_blocks.cu").read_text() if src is None else src
    src = src[: src.index('extern "C" {')]
    for old, new in _SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return _PRELUDE + src + _HARNESS


def build_emulation(d, source: str):
    """Compile ``source`` (the emulation's C++) in directory ``d``; returns
    ``run(blocks, blens, min_profit) -> (out, olens)`` and the library."""
    cpp, so = d / "encode_blocks_host.cpp", d / "encode_blocks_host.so"
    cpp.write_text(source)
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-fno-strict-aliasing", "-pthread", "-fPIC", "-shared", "-Wall", str(cpp), "-o", str(so)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.emu_encode_blocks.argtypes = [p, p, i64, i64, i64, ctypes.c_int, p, p]
    lib.emu_encode_blocks.restype = ctypes.c_int

    def run(blocks, blens, min_profit):
        rows, row_w = blocks.shape
        buf = np.full(rows * BLOCK_MAX_OUT + 2 * GUARD, 0xAB, np.uint8)
        olens = np.full(rows, 7, np.int32)
        rc = lib.emu_encode_blocks(
            blocks.ctypes.data, blens.ctypes.data, rows, row_w, BLOCK_MAX_OUT, min_profit,
            buf.ctypes.data + GUARD, olens.ctypes.data,
        )
        assert rc == 0
        assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
        return buf[GUARD:-GUARD].reshape(rows, BLOCK_MAX_OUT), olens

    return run, lib


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("encode_blocks_host"), _emulation_source())


@pytest.fixture(scope="module")
def emu(emu_lib):
    return emu_lib[0]


def _rows(block: int = 65536):
    """Seeded rows: corpus slices of every length class, whole corpus
    blocks, the sentinel and RLE rows, lengths 0-3, a match that reaches
    the end of the block, and random bytes; none longer than ``block``."""
    rng = np.random.default_rng(3)
    rows = []
    for name in ["html", "alice29.txt", "kppkn.gtb", "geo.protodata", "urls.10K", "fireworks.jpeg"]:
        data = read_testdata(name)
        for _ in range(2):
            n = int(rng.integers(4, 6000))
            s = int(rng.integers(0, len(data) - n))
            rows.append(data[s : s + n])
    rows += [read_testdata("html")[:block], read_testdata("sample-tweet.json")[:block]]
    rows += [b"\xff" * block, b"q" * block, b"ab" * 2000, b"abc", b"ab", b"a", b""]
    rows += [bytes(range(256)) * 8, b"xyzw" * 5 + b"xyzw12", b"\xff\xff\xff\xff\x01" * 300]
    rows += [rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()]
    rows += [rng.integers(0, 4, 3000, dtype=np.uint8).tobytes()]
    return rows


def _batch(rows, width):
    blocks = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
    return blocks, np.array([len(r) for r in rows], np.int32)


def _plain(blocks, blens, min_profit):
    out, olens = encode_torch.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(blens), min_profit)
    return out.numpy(), olens.numpy()


@pytest.mark.parametrize("bits,min_profit", _by_width(lambda bits: [(2,), (1,), (0,), (3,)]))
def test_kernel_matches_plain_version(emu, bits, min_profit):
    blocks, blens = _batch(_rows(1 << bits), WIDTHS[bits])
    out, olens = emu(blocks, blens, min_profit)
    p_out, p_olens = _plain(blocks, blens, min_profit)
    np.testing.assert_array_equal(olens, p_olens)
    np.testing.assert_array_equal(out, p_out)
    assert (olens > 0).sum() == len(blens) - 1


def test_bytes_past_blen_read_as_zero(emu):
    """A row with data past its blen encodes as if it were zero there: the
    candidate scores read 4 bytes past a position, up to blen + 3."""
    html = read_testdata("html")
    width = 4096 + ENC_PAD
    blocks, blens = _batch([b"abcdabcdabcd", html[:4000]], width)
    clean = emu(blocks, blens, 2)
    blocks[0, 12:] = ord("a")
    blocks[1, 4000:] = np.frombuffer(html[4000:width], np.uint8)
    dirty = emu(blocks, blens, 2)
    for a, b in zip(clean, dirty):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(clean[1], _plain(blocks, blens, 2)[1])


def test_kernel_refuses_lengths_outside_the_batch(emu):
    """Lengths the CUDA wrapper does not read on the host: the kernel's own
    guard turns such a row into olens = -1 and an all-zero row; the rows
    around it encode as usual, in either variant: a narrow batch and the
    widths of both."""
    text = read_testdata("alice29.txt")[:1000]
    for width in (1000 + ENC_PAD, *WIDTHS.values()):
        lens = [1000, width - ENC_PAD + 1, -1, 1 << 20, 1000]
        blocks = np.zeros((len(lens), width), np.uint8)
        blocks[:, :1000] = np.frombuffer(text, np.uint8)
        out, olens = emu(blocks, np.array(lens, np.int32), 2)
        assert olens[1:4].tolist() == [-1, -1, -1] and not out[1:4].any(), width
        good, good_lens = _plain(blocks[:1], np.array([1000], np.int32), 2)
        for r in (0, 4):
            assert olens[r] == good_lens[0], width
            np.testing.assert_array_equal(out[r], good[0])


def _expect(bits):
    """What each chase row of the variant must do in the plain parse at
    min_profit 2, where it says."""
    chunk, n, size = record_chunk(bits), 1 << bits, f"{1 << (bits - 10)}k"
    return {
        "text-more-takes-than-a-chunk": lambda t: len(t) > 2 * chunk,
        f"html-{size}": lambda t: len(t) > chunk,
        **{f"match-{m}-{far}": (lambda t, m=m: m in {k for _, k in t}) for m in (7, 8, 9) for far in ("near", "far")},
        f"rle-{size}": lambda t: t == [(1, n - 1)],
        f"zeros-{size}": lambda t: t == [(1, n - 1)],
        f"period-3-{size}": lambda t: t == [(3, n - 3)],
        "match-cut-at-the-row-end": lambda t: t == [(40, 30)],
        "literals-across-chunks": lambda t: len(t) > 2 * chunk,
        "1-chunks-exactly-full": lambda t: len(t) == chunk,
        "2-chunks-exactly-full": lambda t: len(t) == 2 * chunk,
        "collision-16k": lambda t: t == [],
    }


CHASE_ROWS = {bits: chase_rows(bits) for bits in WIDTHS}
EXPECT = {bits: _expect(bits) for bits in WIDTHS}


@pytest.mark.parametrize(
    "bits,name,min_profit", _by_width(lambda bits: [(name, mp) for name in CHASE_ROWS[bits] for mp in (0, 1, 2, 3)]))
def test_chase_rows_match_plain_version(emu, bits, name, min_profit):
    row = CHASE_ROWS[bits][name]
    assert EXPECT[bits].keys() == CHASE_ROWS[bits].keys()
    if min_profit == 2:
        assert EXPECT[bits][name](plain_takes(row, 2)), f"{name}: the row does not exercise what it is for"
    blocks, blens = _batch([row], WIDTHS[bits])
    out, olens = emu(blocks, blens, min_profit)
    p_out, p_olens = _plain(blocks, blens, min_profit)
    np.testing.assert_array_equal(olens, p_olens)
    np.testing.assert_array_equal(out, p_out)


@pytest.mark.parametrize("limit", [9, 20, 47, 48, 49, 1000])
def test_extend_counts_on_from_the_capped_length(emu_lib, limit):
    """The chase extends only a match that the candidate pass found equal
    for its first 8 bytes, and takes them as given: the count starts at 8
    whatever those bytes hold, and stops at the first byte that differs
    or at limit."""
    lib = emu_lib[1]
    lib.emu_extend.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.emu_extend.restype = ctypes.c_uint32
    row = np.random.default_rng(5).integers(0, 256, 4096 + 16, dtype=np.uint8)
    a, b = 3001, 101
    row[a + 8 : a + 48] = row[b + 8 : b + 48]
    row[a + 48] = row[b + 48] ^ 0xFF
    row[a] = row[b] ^ 0xFF
    assert lib.emu_extend(row.ctypes.data, a, b, limit) == min(48, limit)


def test_collision_block_keys_are_distinct_and_share_a_hash():
    """The collision block of each variant: its keys share one hash of the
    variant's width, so that every chain holds all the earlier keys."""
    for bits in WIDTHS:
        n = 1 << bits
        row = np.frombuffer(collision_block(n, bits=hash_bits(bits)), np.uint8)
        keys = row.view("<u4").astype(np.uint64)
        assert len(np.unique(keys)) == len(keys) == n // 4 and not (keys == 0xFFFFFFFF).any()
        hashes = ((keys * HASH_MUL) & 0xFFFFFFFF) >> (32 - hash_bits(bits))
        assert len(np.unique(hashes)) == 1, bits


def test_the_launcher_picks_the_variant_by_row_width(emu_lib):
    """Rows of up to 32 KiB of block take the 32 KiB variant, wider ones the
    64 KiB variant, whose constants are those before the variants came: a
    chase chunk of 376 records and 232,432 bytes of shared memory. Two
    blocks of the 32 KiB variant, each with the 1 KiB the card reserves a
    block, fit the SM's 233,472 bytes."""
    lib = emu_lib[1]
    lib.emu_block_bits.argtypes = [ctypes.c_int64]
    lib.emu_smem_bytes.restype = ctypes.c_int64
    assert [lib.emu_block_bits(w) for w in (ENC_PAD, 1000 + ENC_PAD, WIDTHS[15], WIDTHS[15] + 1, WIDTHS[16])] == [
        15, 15, 15, 16, 16]
    assert lib.emu_smem_bytes(16) == 232432 and lib.emu_chunk(16) == record_chunk(16) == 376
    assert lib.emu_chunk(15) == record_chunk(15)
    assert 2 * (lib.emu_smem_bytes(15) + 1024) <= 233472 < 2 * (lib.emu_smem_bytes(16) + 1024)
