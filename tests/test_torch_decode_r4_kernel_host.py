"""K3's CUDA source, compiled with g++ as a host emulation of its thread
block, against the port's plain K3 (``decode_torch.decode_blocks_r4``).

The kernel cannot run without a card, so this holds its logic here: the
device code of ``snappy_tpu_torch/csrc/decode_blocks_r4.cu`` (everything
before its ``extern "C"`` launcher) is compiled unchanged but for a few
textual substitutions, with one ``std::thread`` per thread of a block of 96
(the walker warp and two drain warps; the thread count is a macro, the card
runs 256), a ``std::barrier`` for ``__syncthreads``, one per named barrier
(``barrier.sync`` waits on it, ``barrier.arrive`` arrives without waiting)
and one per warp for ``__syncwarp``, and a static buffer for its shared
memory. Both variants run: the output staged in shared memory, and the
output in device memory (rows too wide to stage). The launcher's choice
between them is checked on the card by ``chip_smoke.py``.

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

from conftest import read_testdata
from torch_helpers import copy1, copy2, kernel_battery, lit, native_body, odd_width_batch, rle, synthetic_cases

OUT_SIZE = 8192
WIDE = 1 << 17
GUARD = 64  # canary bytes on each side of the output rows
SLACK = 16  # bytes around the compressed rows, which the walk reads as aligned words

_PRELUDE = r"""
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
#define SNAPPY_R4_THREADS 96
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct alignas(16) uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return uint4{x, y, z, w}; }
struct Idx { int64_t x; };
thread_local Idx threadIdx, blockIdx;
constexpr int kEmuWarps = SNAPPY_R4_THREADS / 32;
static std::barrier<>* g_block_bar;
static std::barrier<>* g_warp_bar[kEmuWarps];
static std::barrier<>* g_named_bar[16];
static uint32_t g_named_count[16];
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
static inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
static inline void __threadfence_block() {}
// Warp shuffles, votes and reductions through an exchange slot a lane.
static uint32_t g_xchg[kEmuWarps][32];
static inline uint32_t* emu_exchange(uint32_t v) {
  uint32_t* x = g_xchg[threadIdx.x / 32];
  x[threadIdx.x % 32] = v;
  __syncwarp();
  return x;
}
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int src) {
  const uint32_t r = emu_exchange(v)[src & 31];
  __syncwarp();
  return r;
}
static inline uint32_t __shfl_up_sync(unsigned m, uint32_t v, unsigned d) {
  const uint32_t lane = threadIdx.x % 32;
  return __shfl_sync(m, v, lane >= d ? lane - d : lane);
}
static inline uint32_t __reduce_or_sync(unsigned, uint32_t v) {
  const uint32_t* x = emu_exchange(v);
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= x[i];
  __syncwarp();
  return r;
}
static inline uint32_t __ballot_sync(unsigned, bool p) {
  const uint32_t* x = emu_exchange(p);
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= (x[i] ? 1u : 0u) << i;
  __syncwarp();
  return r;
}
static inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p) != 0; }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
static inline int __clz(uint32_t x) { return x ? __builtin_clz(x) : 32; }
static inline std::barrier<>* emu_named(uint32_t id, uint32_t n) {
  if (id >= 16 || !g_named_bar[id] || g_named_count[id] != n) std::abort();
  return g_named_bar[id];
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return uint32_t(((uint64_t(hi) << 32) | lo) >> (sh & 31));
}
static inline uint32_t __funnelshift_rc(uint32_t lo, uint32_t hi, uint32_t sh) {
  return uint32_t(((uint64_t(hi) << 32) | lo) >> (sh < 32 ? sh : 32));
}
constexpr int64_t kSmemBytes = 1 << 20;
alignas(16) static uint8_t g_smem[kSmemBytes];
"""

_HARNESS = r"""
// Run the kernel over `rows` blocks, one block at a time, with kThreads
// std::threads as its threads. mode 0: the output staged in shared memory,
// 1: in device memory. Returns 0, or 1 if the shared memory does not fit
// the emulated buffer.
extern "C" int emu_decode_blocks_r4(const uint8_t* comp, const int32_t* clens,
                                    const int32_t* ulens, int64_t rows, int64_t row_c,
                                    int64_t out_size, uint8_t* out, uint8_t* ok,
                                    int32_t* total, int mode) {
  if (kHeadBytes + round16(out_size) > kSmemBytes) return 1;
  std::barrier<> block_bar(kThreads);
  g_block_bar = &block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (uint32_t w = 0; w < kEmuWarps; ++w) {
    bars.emplace_back(new std::barrier<>(kWarp));
    g_warp_bar[w] = bars.back().get();
  }
  const uint32_t named[][2] = {{kFullBar, kThreads}, {kFullBar + 1, kThreads}, {kEmptyBar, kThreads},
                               {kEmptyBar + 1, kThreads}, {kDrainBar, kDrainThreads}};
  for (auto [id, n] : named) {
    bars.emplace_back(new std::barrier<>(n));
    g_named_bar[id] = bars.back().get();
    g_named_count[id] = n;
  }
  std::vector<std::thread> threads;
  for (uint32_t t = 0; t < kThreads; ++t) {
    threads.emplace_back([=, &block_bar] {
      threadIdx.x = t;
      for (int64_t r = 0; r < rows; ++r) {
        blockIdx.x = r;
        if (mode == 0)
          decode_blocks_r4_kernel<true>(comp, clens, ulens, row_c, out_size, out, ok, total);
        else
          decode_blocks_r4_kernel<false>(comp, clens, ulens, row_c, out_size, out, ok, total);
        block_bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

extern "C" int emu_chunk() { return kChunk; }
extern "C" int emu_group() { return kGroup; }
"""

# (text in the kernel source, its host replacement)
_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;"),
    ('__device__ __forceinline__ void bar_sync(uint32_t id, uint32_t n) { asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory"); }',
     "static inline void bar_sync(uint32_t id, uint32_t n) { emu_named(id, n)->arrive_and_wait(); }"),
    ('__device__ __forceinline__ void bar_arrive(uint32_t id, uint32_t n) { asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(n) : "memory"); }',
     "static inline void bar_arrive(uint32_t id, uint32_t n) { (void)emu_named(id, n)->arrive(); }"),
    ('__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }',
     "static inline void prefetch_l2(const void*) {}"),
    ("__device__ __forceinline__ uint32_t shared_addr(const void* p) { return uint32_t(__cvta_generic_to_shared(p)); }",
     "static inline uint32_t shared_addr(const void* p) { return uint32_t(static_cast<const uint8_t*>(p) - g_smem); }"),
    ('__device__ __forceinline__ uint32_t lds(uint32_t a) { uint32_t v; asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory"); return v; }',
     "static inline uint32_t lds(uint32_t a) { return *reinterpret_cast<const uint32_t*>(g_smem + a); }"),
]

MODES = {"output-staged": 0, "device-memory": 1}


def _emulation_source(src: str | None = None) -> str:
    src = (CSRC / "decode_blocks_r4.cu").read_text() if src is None else src
    src = src[: src.index('extern "C" {')]
    for old, new in _SUBSTITUTIONS:
        assert src.count(old) == 1, f"kernel source no longer holds {old!r}"
        src = src.replace(old, new)
    return _PRELUDE + src + _HARNESS


def build_emulation(d, source: str):
    """Compile ``source`` (the emulation's C++) in directory ``d``; returns
    ``run(comp, clens, ulens, out_size, mode) -> (out, ok, total)`` and the
    library."""
    cpp, so = d / "decode_blocks_r4_host.cpp", d / "decode_blocks_r4_host.so"
    cpp.write_text(source)
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
        # The rows start SLACK bytes into an aligned buffer: the walk reads
        # the row's aligned words, up to 3 bytes past the last row.
        held = np.zeros(comp.size + 2 * SLACK, np.uint8)
        held[SLACK : SLACK + comp.size] = comp.reshape(-1)
        buf = np.full(rows * out_size + 2 * GUARD, 0xAB, np.uint8)
        ok = np.full(rows, 7, np.uint8)
        total = np.zeros(rows, np.int32)
        rc = lib.emu_decode_blocks_r4(
            held.ctypes.data + SLACK, clens.ctypes.data, ulens.ctypes.data, rows, row_c, out_size,
            buf.ctypes.data + GUARD, ok.ctypes.data, total.ctypes.data, mode,
        )
        assert rc == 0
        assert (buf[:GUARD] == 0xAB).all() and (buf[-GUARD:] == 0xAB).all(), "wrote outside the rows"
        assert set(np.unique(ok)) <= {0, 1}
        return buf[GUARD:-GUARD].reshape(rows, out_size), ok.astype(bool), total

    return run, lib


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    return build_emulation(tmp_path_factory.mktemp("decode_blocks_r4_host"), _emulation_source())


@pytest.fixture(scope="module")
def emu(emulation):
    return emulation[0]


@pytest.fixture(scope="module")
def chunk(emulation):
    lib = emulation[1]
    return lib.emu_chunk(), lib.emu_group()


def r4_records(body: bytes, chunk: int, group: int) -> dict:
    """The walk's tallies of a valid tag stream as the kernel keeps them:
    tags, records (one a tag), chunks of ``chunk`` records, copy groups of
    ``group`` and the groups whose copies reach at or past the group's first
    output position (flagged)."""
    ip = op = tags = chunks = groups = flagged = 0
    nl = nc = 0
    lead = 0
    flags: set[int] = set()

    def close():
        nonlocal chunks, groups, flagged, nl, nc
        chunks += 1
        groups += -(-nc // group)
        flagged += len(flags)
        flags.clear()
        nl = nc = 0

    while ip < len(body):
        if nl + nc == chunk:
            close()
        c = body[ip]
        kind, hi6 = c & 3, c >> 2
        tags += 1
        if kind == 0:
            tl = max(hi6 - 59, 0)
            n = (int.from_bytes(body[ip + 1 : ip + 1 + tl], "little") if tl else hi6) + 1
            ip += 1 + tl + n
            nl += 1
        else:
            tl = {1: 1, 2: 2, 3: 4}[kind]
            trailer = int.from_bytes(body[ip + 1 : ip + 1 + tl], "little")
            n = 4 + (hi6 & 7) if kind == 1 else hi6 + 1
            f = ((c >> 5) << 8) | trailer if kind == 1 else trailer
            ip += 1 + tl
            if nc % group == 0:
                lead = op
            if op - f + min(n, f) > lead:
                flags.add(nc // group)
            nc += 1
        op += n
    close()
    return {"tags": tags, "records": tags, "chunks": chunks, "groups": groups, "flagged": flagged}


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


def _assert_decodes(emu, rows, mode, out_size=OUT_SIZE):
    """(body, expected bytes) rows: every row ok, its bytes, and the plain
    version's result."""
    comp, clens, ulens = odd_width_batch([(b, len(exp)) for b, exp in rows])
    got = emu(comp, clens, ulens, out_size, mode)
    _assert_same(got, _plain(comp, clens, ulens, out_size))
    assert got[1].all()
    for i, (_, exp) in enumerate(rows):
        assert got[0][i, : len(exp)].tobytes() == exp


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
        (lit(b"a") + copy2(64, 1) * 2047, 1 + 64 * 2047),  # exactly one K3 chunk after folding
        (native_body(bytes(rng.integers(0, 4, 100_000, dtype=np.uint8))), 100_000),
    ]
    rows += [(body, u) for _, body, u, _ in synthetic_cases()]
    return rows


STAGING = pytest.mark.parametrize("mode", list(MODES.values()), ids=list(MODES))


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


@STAGING
def test_streams_of_many_chunks(emu, chunk, mode):
    """Streams of more than two record chunks, so that the walker refills
    each chunk while the drain warps hold the other: corpus blocks, and
    runs of copies and literals that fill chunks exactly and not."""
    n, group = chunk
    data = read_testdata("alice29.txt")[:65536]
    base = bytes(range(40))
    runs = lit(base) + (copy1(8, 40) + lit(b"x")) * (3 * n // 2) + copy1(11, 17)
    exact = lit(base) + copy1(8, 40) * (3 * n - 1)
    rows = [
        (native_body(data), data),
        (native_body(read_testdata("html")[:65536]), read_testdata("html")[:65536]),
        (runs, _plain_bytes(runs, 40 + (3 * n // 2) * 9 + 11)),
        (exact, rle(base, 8 * (3 * n - 1), 40)),
    ]
    for body, _ in rows:
        assert r4_records(body, n, group)["chunks"] > 2
    _assert_decodes(emu, rows, mode, 1 << 16)


@STAGING
@pytest.mark.parametrize("where", ["split", "inside"])
def test_fold_pair_across_a_chunk_boundary(emu, chunk, mode, where):
    """A 64-byte COPY_2 and the COPY_2 of the same offset after it, which
    K3's prepass folds into one record: split, the first is a chunk's last
    record and the second the next chunk's first; inside, both lie in one
    chunk. The kernel keeps a record a tag and decodes both alike."""
    n, group = chunk
    base = bytes(range(20)) * 3
    fill = n - 2 if where == "split" else n - 3
    body = lit(base) + copy1(8, 20) * fill + copy2(64, 20) + copy2(10, 20) + copy1(4, 7)
    exp = rle(base, 8 * fill + 64 + 10, 20)
    exp = rle(exp, 4, 7)
    tally = r4_records(body, n, group)
    assert tally["chunks"] == 2 and tally["records"] == tally["tags"] == fill + 4
    _assert_decodes(emu, [(body, exp)], mode)


@STAGING
def test_groups_with_and_without_the_flag(emu, chunk, mode):
    """Copy groups the walker flags (a copy reads output of its own group)
    and groups it does not (every copy reads before the group), alone and
    mixed in one stream."""
    n, group = chunk
    base = bytes(np.random.default_rng(9).integers(0, 256, 4096, dtype=np.uint8))
    far = b"".join(lit(base[i : i + 60]) for i in range(0, 600, 60))
    far += b"".join(copy2(8, 200 + 3 * k) for k in range(4 * group))
    near = lit(base[:60]) + b"".join(copy1(4 + k % 8, 1 + k % 3) for k in range(4 * group))
    mixed = far + near
    rows = []
    for body in (far, near, mixed):
        rows.append((body, _plain_bytes(body, None)))
    assert r4_records(far, n, group)["flagged"] == 0
    assert r4_records(near, n, group)["flagged"] == r4_records(near, n, group)["groups"] == 4
    assert 0 < r4_records(mixed, n, group)["flagged"] < r4_records(mixed, n, group)["groups"]
    _assert_decodes(emu, rows, mode)


@STAGING
def test_rle_copy_at_a_groups_first_record(emu, chunk, mode):
    """A copy of offset 1 as the first record of a group: it reads the byte
    just before the group (a literal, or the last copy of the group before),
    and is never flagged itself."""
    _, group = chunk
    base = bytes(range(50))
    first = lit(b"a") + copy2(64, 1) + copy1(5, 1)
    second = lit(base) + copy1(8, 40) * group + copy1(11, 1) + copy1(6, 30)
    third = lit(base) + copy1(8, 40) * group + lit(b"z") + copy1(9, 1)
    rows = [(body, _plain_bytes(body, None)) for body in (first, second, third)]
    assert rows[0][1] == b"a" * 70
    assert rows[1][1][50 + 8 * group : 50 + 8 * group + 11] == bytes([rows[1][1][50 + 8 * group - 1]]) * 11
    assert rows[2][1].endswith(b"z" * 10)
    _assert_decodes(emu, rows, mode)


def _plain_bytes(body: bytes, ulen: int | None) -> bytes:
    """The plain version's bytes of a stream that must decode, its length
    found by walking the tags when ``ulen`` is None."""
    if ulen is None:
        ulen, ip = 0, 0
        while ip < len(body):
            c = body[ip]
            if c & 3 == 0:
                tl = max((c >> 2) - 59, 0)
                n = (int.from_bytes(body[ip + 1 : ip + 1 + tl], "little") if tl else c >> 2) + 1
                ip += 1 + tl + n
            else:
                n = 4 + ((c >> 2) & 7) if c & 3 == 1 else (c >> 2) + 1
                ip += 1 + {1: 1, 2: 2, 3: 4}[c & 3]
            ulen += n
    comp = np.zeros((1, len(body) + 4), np.uint8)
    comp[0, : len(body)] = np.frombuffer(body, np.uint8)
    out, ok, total = _plain(comp, np.array([len(body)], np.int32), np.array([ulen], np.int32), max(ulen, 1))
    assert ok[0] and total[0] == ulen
    return out[0, :ulen].tobytes()
