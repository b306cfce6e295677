"""K4 (``csrc/segment_streams.cu``) and K1's ragged variant
(``csrc/decode_blocks.cu``) compiled with g++ as host emulations of their
warps, against their plain versions on the CPU.

The kernels cannot run without a card, so this holds their logic here, as
``test_torch_kernel_host.py`` does for K1's fixed rows: the device code of
each source (everything before its ``extern "C"`` launcher) is compiled
unchanged but for its cuda_runtime include, with a ``std::thread`` a thread
of the block (K4's two warps, K1's one) and a ``std::barrier`` a warp for
``__syncwarp`` and one for ``__syncthreads``, a warp's shuffles, ballot and
sum through an exchange array between two such barriers, its
``__shared__`` arrays as statics and ``atomicAdd`` as a plain add (one
block runs at a time). Blocks run in order, so K4's streams reserve their
rows in stream order, as the plain version's do.

K4 runs on the crafted streams at the segmenter's edges and on seeded
libsnappy-parse streams, laid out at any offset of one buffer, from a
16-byte-aligned buffer (its 16-byte ring loads) and from one that is not
(its byte loads), with a table too small for the last streams, and the
crafted ones with a ring of 64 bytes. Its sliced path runs built with
slices of 1 KiB or 256 bytes, so that every stream longer than a slice is
charted slice by slice and joined: on streams at its edges (64 KiB marks
inside slices, a merge reaching back across a slice, a long literal over
many slices, a fault in the last slice, bodies at the threshold, a stream
whose charts never fall into step with it), aligned or not, with a small
table, with too few summary slots, and built so that a block charts one
slice and leaves, so that other blocks chart the rest and join them.
K1's ragged variant runs on the rows the plain K4 gives,
with its source's window and ring and with a window of 256 bytes and a ring
of 64, so that every row stages and flushes many times.

Tolerance: exact. K4's rows, flags and four counts equal the plain version's;
K1's ok and output bytes equal the plain ragged walk's, its totals where
ok; neither writes outside its buffers.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import cuda_decode, cuda_segment
from snappy_tpu_torch.ops.kernels import CSRC

import stream_cases
from conftest import read_testdata
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from test_torch_kernel_host import PRELUDE as K1_PRELUDE
from torch_helpers import copy1, copy2, lit

GUARD = 64

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
// A barrier a warp for __syncwarp, one for the block's __syncthreads.
static std::barrier<>* g_warp_bar[2];
static std::barrier<>* g_block_bar;
static inline void __syncwarp() { g_warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
static inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
// A warp's shuffles, sum and ballot through its half of an exchange array
// between barriers.
static uint64_t g_xchg[64];
template <class T> static inline T __shfl_sync(unsigned, T v, int from) {
  g_xchg[threadIdx.x] = static_cast<uint64_t>(v);
  __syncwarp();
  const T r = static_cast<T>(g_xchg[(threadIdx.x & ~int64_t(31)) + from]);
  __syncwarp();
  return r;
}
template <class T> static inline T __shfl_up_sync(unsigned, T v, int d) {
  g_xchg[threadIdx.x] = static_cast<uint64_t>(v);
  __syncwarp();
  const T r = (threadIdx.x & 31) >= d ? static_cast<T>(g_xchg[threadIdx.x - d]) : v;
  __syncwarp();
  return r;
}
static inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  g_xchg[threadIdx.x] = v;
  __syncwarp();
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i) sum += unsigned(g_xchg[(threadIdx.x & ~int64_t(31)) + i]);
  __syncwarp();
  return sum;
}
static inline unsigned __ballot_sync(unsigned, bool p) {
  g_xchg[threadIdx.x] = p;
  __syncwarp();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= unsigned(g_xchg[(threadIdx.x & ~int64_t(31)) + i]) << i;
  __syncwarp();
  return m;
}
// One block runs at a time, and only its lane 0 adds.
static inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  const unsigned long long old = *a;
  *a = old + v;
  return old;
}
static inline unsigned atomicAdd(unsigned* a, unsigned v) {
  const unsigned old = *a;
  *a = old + v;
  return old;
}
static inline void __nanosleep(unsigned) {}
static inline void __threadfence() {}
template <class T> static inline T __ldcg(const T* p) { return *p; }
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return uint4{x, y, z, w}; }
static inline int __ffs(unsigned x) { return __builtin_ffs(int(x)); }
template <class T> static inline T __shfl_down_sync(unsigned, T v, int d) {
  g_xchg[threadIdx.x] = static_cast<uint64_t>(v);
  __syncwarp();
  const T r = (threadIdx.x & 31) + d < 32 ? static_cast<T>(g_xchg[threadIdx.x + d]) : v;
  __syncwarp();
  return r;
}
static inline int __reduce_min_sync(unsigned, int v) {
  g_xchg[threadIdx.x] = static_cast<uint64_t>(int64_t(v));
  __syncwarp();
  int least = v;
  for (int i = 0; i < 32; ++i) {
    const int x = int(int64_t(g_xchg[(threadIdx.x & ~int64_t(31)) + i]));
    least = x < least ? x : least;
  }
  __syncwarp();
  return least;
}
"""

K4_HARNESS = r"""
extern "C" int64_t emu_ctl_words(int64_t comp_len, int64_t n) { return ctl_words(comp_len, n); }
// `blocks` blocks, one after another; ctl zero; `pool` summary slots, or
// as many as the kernel's launcher gives where it is 0.
extern "C" void emu_segment_streams(const uint8_t* comp, int64_t comp_len, const int64_t* starts,
                                    const int32_t* clens, const int32_t* ulens, const int64_t* out_starts,
                                    int64_t out_len, int64_t n, int64_t capacity, int64_t* rin, int64_t* rout,
                                    int32_t* rclen, int32_t* rulen, int32_t* rstream, uint8_t* ok,
                                    unsigned long long* ctl, int64_t blocks, int64_t pool) {
  std::barrier<> w0(kWarp), w1(kWarp), bar(kThreads);
  g_warp_bar[0] = &w0;
  g_warp_bar[1] = &w1;
  g_block_bar = &bar;
  const Rows rows{rin, rout, rclen, rulen, rstream};
  pool = pool ? pool : pool_for(comp_len, n);
  std::vector<uint4> sums(size_t(pool) * kSumWords);
  const Work work{ctl + kStats, reinterpret_cast<Long*>(ctl + kCtlHead),
                  reinterpret_cast<uint32_t*>(ctl + kCtlHead + 4 * n), sums.data(), uint64_t(pool)};
  std::vector<std::thread> threads;
  for (int t = 0; t < kThreads; ++t) {
    threads.emplace_back([=, &bar] {
      threadIdx.x = t;
      for (int64_t b = 0; b < blocks; ++b) {
        blockIdx.x = b;
        segment_streams_kernel(comp, comp_len, starts, clens, ulens, out_starts, out_len, n, capacity, rows, ok,
                               ctl, work);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : threads) t.join();
}
"""

K1_HARNESS = r"""
extern "C" void emu_decode_segments(const uint8_t* comp, int64_t comp_len, const int64_t* in_starts,
                                    const int32_t* clens, const int64_t* out_starts, const int32_t* ulens,
                                    const int32_t* streams, const int64_t* rows, int64_t max_rows, uint8_t* out,
                                    int64_t out_len, uint8_t* ok, int32_t* total, uint8_t* stream_ok) {
  std::barrier<> bar(kWarp);
  g_bar = &bar;
  const Ragged rag{in_starts, out_starts, streams, stream_ok, rows, comp_len, out_len};
  std::vector<std::thread> lanes;
  for (int l = 0; l < kWarp; ++l) {
    lanes.emplace_back([=, &bar] {
      threadIdx.x = l;
      for (int64_t r = 0; r < max_rows; ++r) {
        blockIdx.x = r;
        decode_blocks_kernel(comp, clens, ulens, out, ok, total, rag);
        bar.arrive_and_wait();
      }
    });
  }
  for (auto& t : lanes) t.join();
}
"""


def device_part(stem: str) -> str:
    src = (CSRC / f"{stem}.cu").read_text()
    src = src[: src.index('extern "C" {')]
    assert src.count("#include <cuda_runtime.h>") == 1, f"{stem}.cu no longer holds its cuda_runtime include"
    return src.replace("#include <cuda_runtime.h>", "")


def build(directory, name: str, source: str, defines=()) -> ctypes.CDLL:
    cpp, so = directory / f"{name}.cpp", directory / f"{name}.so"
    cpp.write_text(source)
    proc = subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-fPIC", "-shared", "-Wall", *defines, str(cpp),
                           "-o", str(so)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """name -> emulation library, each built once."""
    built = {}

    def get(name):
        if name not in built:
            d = tmp_path_factory.mktemp(name)
            if name.startswith("k4"):
                built[name] = build(d, "k4", PRELUDE + device_part("segment_streams") + K4_HARNESS, K4_BUILDS[name])
            else:
                defines = ["-DSNAPPY_K1_WINDOW=256", "-DSNAPPY_K1_RING=64"] if name == "k1-window-256" else []
                built[name] = build(d, "k1", K1_PRELUDE + device_part("decode_blocks") + K1_HARNESS, defines)
        return built[name]

    return get


# K4's builds: its source's ring and slice; a ring of 64 bytes (slices of
# 128); slices of 1 KiB on a ring of 256; the same where a block charts one
# slice and leaves, so that other blocks chart the rest and join them;
# slices of 256 bytes on a ring of 64.
K4_BUILDS = {
    "k4": [],
    "k4-ring-64": ["-DSNAPPY_K4_RING=64"],
    "k4-slice-1024": ["-DSNAPPY_K4_RING=256", "-DSNAPPY_K4_SLICE=1024"],
    "k4-slice-1024-claims-1": ["-DSNAPPY_K4_RING=256", "-DSNAPPY_K4_SLICE=1024", "-DSNAPPY_K4_CLAIMS=1"],
    "k4-slice-256": ["-DSNAPPY_K4_RING=64", "-DSNAPPY_K4_SLICE=256"],
}


def cases(natives: int = 3):
    return stream_cases.crafted() + stream_cases.native(11, natives)


def run_k4(lib, args, capacity: int, misalign: int = 0, blocks: int = 2, pool: int = 0):
    """K4's emulation on ``decompress_streams``'s arguments in ``blocks``
    blocks, with ``pool`` summary slots (0: the launcher's): (rows, ok,
    stats) as numpy arrays, rows past the reservation zero, stats K4's seven
    counts."""
    comp, starts, clens, ulens, out_starts, out_len = args
    buf = np.zeros(comp.numel() + 16 + misalign, np.uint8)
    at = (-buf.ctypes.data) % 16 + misalign
    buf[at : at + comp.numel()] = comp.numpy()
    cols = [np.zeros(capacity, np.int64), np.zeros(capacity, np.int64), np.zeros(capacity, np.int32),
            np.zeros(capacity, np.int32), np.zeros(capacity, np.int32)]
    guard = [np.zeros(capacity + GUARD, c.dtype) for c in cols]
    ok = np.full(len(starts), 7, np.uint8)
    n = len(starts)
    lib.emu_ctl_words.restype = ctypes.c_int64
    ctl = np.zeros(lib.emu_ctl_words(ctypes.c_int64(comp.numel()), ctypes.c_int64(n)), np.uint64)
    st, cl, ul, os_ = (np.ascontiguousarray(t.numpy()) for t in (starts, clens, ulens, out_starts))
    lib.emu_segment_streams(
        ctypes.c_void_p(buf.ctypes.data + at), ctypes.c_int64(comp.numel()), st.ctypes.data_as(ctypes.c_void_p),
        cl.ctypes.data_as(ctypes.c_void_p), ul.ctypes.data_as(ctypes.c_void_p), os_.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(out_len), ctypes.c_int64(n), ctypes.c_int64(capacity),
        *(ctypes.c_void_p(g.ctypes.data) for g in guard), ctypes.c_void_p(ok.ctypes.data),
        ctypes.c_void_p(ctl.ctypes.data), ctypes.c_int64(blocks), ctypes.c_int64(pool))
    stats = ctl[: len(cuda_segment.STATS)]
    for g in guard:
        assert not g[capacity:].any(), "wrote past the table"
    reserved = int(stats[0])
    for c, g in zip(cols, guard):
        c[: min(reserved, capacity)] = g[: min(reserved, capacity)]
    assert set(np.unique(ok)) <= {0, 1}
    return cols, ok, stats.astype(np.int64)


def plain_k4(args, capacity: int):
    rows, ok, stats = cuda_segment.segment_streams_plain(*args, capacity)
    return [r.numpy() for r in rows], ok.numpy(), stats.numpy()


@pytest.mark.parametrize("variant", ["aligned", "unaligned-buffer", "ring-64", "small-table"])
def test_k4_matches_its_plain_version(libs, variant):
    cs = cases(0 if variant == "ring-64" else 3)
    args = stream_cases.lay_out(cs, 5)
    capacity = cuda_segment.capacity_for(len(cs), args[5])
    if variant == "small-table":
        capacity = 12
    lib = libs("k4-ring-64" if variant == "ring-64" else "k4")
    got_rows, got_ok, got_stats = run_k4(lib, args, capacity, misalign=3 if variant == "unaligned-buffer" else 0)
    want_rows, want_ok, want_stats = plain_k4(args, capacity)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_stats[:4], want_stats[:4])
    used = min(int(want_stats[0]), capacity)
    for got, want in zip(got_rows, want_rows):
        np.testing.assert_array_equal(got[:used], want[:used])
    if variant == "small-table":
        assert not got_ok[-1] and got_ok[0]
    else:
        assert got_ok.tolist() == [stream_cases.native_scan(c[1], c[2]) != "corrupt" for c in cs]


def run_k1(lib, args, rows, nrows: int):
    comp, out_len = args[0], args[5]
    cbuf = np.ascontiguousarray(comp.numpy())
    out = np.full(out_len + 2 * GUARD, 0xAB, np.uint8)
    r = len(rows[0])
    ok = np.full(r, 7, np.uint8)
    total = np.zeros(r, np.int32)
    stream_ok = np.ones(len(args[1]), np.uint8)
    count = np.array([nrows], np.int64)
    p = [np.ascontiguousarray(x) for x in rows]
    lib.emu_decode_segments(
        ctypes.c_void_p(cbuf.ctypes.data), ctypes.c_int64(len(cbuf)), ctypes.c_void_p(p[0].ctypes.data),
        ctypes.c_void_p(p[2].ctypes.data), ctypes.c_void_p(p[1].ctypes.data), ctypes.c_void_p(p[3].ctypes.data),
        ctypes.c_void_p(p[4].ctypes.data), ctypes.c_void_p(count.ctypes.data), ctypes.c_int64(r),
        ctypes.c_void_p(out.ctypes.data + GUARD), ctypes.c_int64(out_len), ctypes.c_void_p(ok.ctypes.data),
        ctypes.c_void_p(total.ctypes.data), ctypes.c_void_p(stream_ok.ctypes.data))
    assert (out[:GUARD] == 0xAB).all() and (out[-GUARD:] == 0xAB).all(), "wrote outside the output"
    return out[GUARD:-GUARD], ok[:nrows].astype(bool), total[:nrows], stream_ok


@pytest.mark.parametrize("build", ["k1", "k1-window-256"])
def test_ragged_k1_matches_the_plain_walk(libs, build):
    cs = cases()
    args = stream_cases.lay_out(cs, 9)
    capacity = cuda_segment.capacity_for(len(cs), args[5])
    rows, k4_ok, stats = plain_k4(args, capacity)
    nrows = int(stats[0])
    # A row that does not fit its buffers, and one whose bytes are corrupt.
    rows = [r.copy() for r in rows]
    target = int(np.flatnonzero(rows[3][:nrows] > 1000)[0])
    rows[0][target] = args[0].numel()
    cut = int(np.flatnonzero(rows[3][:nrows] > 1000)[1])
    rows[2][cut] //= 2
    out, ok, total, stream_ok = run_k1(libs(build), args, rows, nrows)
    want_out = torch.full((args[5],), 0xAB, dtype=torch.uint8)
    want_stream_ok = torch.ones(len(cs), dtype=torch.uint8)
    want_ok, want_total = cuda_decode.decode_segments_plain(
        args[0], tuple(torch.from_numpy(r) for r in rows), nrows, want_out, want_stream_ok)
    np.testing.assert_array_equal(ok, want_ok[:nrows].numpy())
    np.testing.assert_array_equal(total[ok], want_total[:nrows].numpy()[ok])
    np.testing.assert_array_equal(stream_ok, want_stream_ok.numpy())
    np.testing.assert_array_equal(out, want_out.numpy())
    assert not ok[target] and not ok[cut] and ok.sum() >= nrows - 3
    assert (out[rows[1][target] : rows[1][target] + rows[3][target]] == 0xAB).all(), "an unfit row wrote"
    assert (out[rows[1][cut] : rows[1][cut] + rows[3][cut]] == 0).all(), "a bad row is zeroed"


# K4's sliced path, built with slices of 1 KiB or 256 bytes, so that every
# stream longer than a slice is cut into many.


def literal_body(length: int, seed: int) -> tuple[bytes, bytes]:
    """(body, output) of literal tags alone, the body exactly ``length``
    bytes (at least 2)."""
    rest, parts = length, []
    while rest > 62:
        parts.append(60)
        rest -= 61
    parts += [rest - 1] if rest <= 61 else [30, rest - 32]
    out = stream_cases._noise(sum(parts), seed)
    body, at = b"", 0
    for p in parts:
        body += lit(out[at : at + p])
        at += p
    return body, out


def case(cid: str, body: bytes, out: bytes, good: bool = True):
    return cid, varint.encode32(len(out)) + body, len(out), out if good else None


def sliced_cases(slice_bytes: int):
    """Streams at the edges of the sliced path, for slices of
    ``slice_bytes``."""
    cases = []
    # 64 KiB marks inside slices: 8-byte literals, each copied on.
    out = b""
    for _ in range(7000):
        out += b"abcdefgh"
        for _ in range(11):
            out += out[-8:-7]
    cases.append(case("marks-inside-slices", (lit(b"abcdefgh") + copy1(11, 8)) * 7000, out))
    # A merge: the segment that the 64 KiB mark opens (at the 1,093rd
    # 60-byte literal) is merged back by a copy a slice on, reaching behind
    # the mark.
    after = slice_bytes // 61 + 2
    body, out = literal_body((1093 + after) * 61, 21)
    back = 60 * after + 100
    out += out[-back : -back + 16]
    cases.append(case("merge-across-slices", body + copy2(16, back), out))
    # A long literal over many slices, between copies.
    a, b = stream_cases._noise(3 * slice_bytes, 22), stream_cases._noise(2 * slice_bytes, 23)
    out = a
    for _ in range(10):
        out += out[-100:-36]
    out += b
    body = stream_cases.long_literal(a) + copy2(64, 100) * 10 + stream_cases.long_literal(b)
    cases.append(case("long-literal-over-slices", body, out))
    # A fault in the last slice: a copy of offset 0 after a native stream.
    raw = read_testdata("html")[:20_000]
    s = nat.compress(raw)
    cases.append(case("fault-in-the-last-slice", s[len(varint.encode32(len(raw))):] + copy2(4, 0), raw + b"xxxx",
                      good=False))
    # Bodies at the threshold: a slice, one byte less and more, two slices.
    for i, length in enumerate((slice_bytes - 1, slice_bytes, slice_bytes + 1, 2 * slice_bytes, 2 * slice_bytes + 1)):
        body, out = literal_body(length, 30 + i)
        cases.append(case(f"body-{length}", body, out))
    return cases


def never_meets():
    """A stream whose copies' offset bytes are themselves 3-byte copy tags
    (0x02, 0x06): a chain that starts one or two bytes into a copy never
    falls into step, so a slice's chart meets the stream only where it
    starts in step."""
    head = stream_cases._noise(2000, 24)
    out = head
    for _ in range(2000):
        for _ in range(64):
            out += out[-0x0602:-0x0602 + 1]
    return case("never-meets", stream_cases.long_literal(head) + copy2(64, 0x0602) * 2000, out)


def check_k4(lib, cs, capacity=None, misalign=0, blocks=3, pool=0):
    """K4's emulation against its plain version on the streams ``cs``:
    rows, flags and counts exactly; returns its seven counts."""
    args = stream_cases.lay_out(cs, 17)
    if capacity is None:
        capacity = cuda_segment.capacity_for(len(cs), args[5])
    got_rows, got_ok, got_stats = run_k4(lib, args, capacity, misalign=misalign, blocks=blocks, pool=pool)
    want_rows, want_ok, want_stats = plain_k4(args, capacity)
    np.testing.assert_array_equal(got_ok, want_ok)
    np.testing.assert_array_equal(got_stats[:4], want_stats[:4])
    used = min(int(want_stats[0]), capacity)
    for got, want in zip(got_rows, want_rows):
        np.testing.assert_array_equal(got[:used], want[:used])
    return got_ok, got_stats


@pytest.mark.parametrize("variant", ["aligned", "unaligned-buffer", "small-table", "other-blocks", "few-slots"])
def test_sliced_k4_matches_its_plain_version(libs, variant):
    cs = sliced_cases(1024) + stream_cases.crafted() + stream_cases.native(19, 2)
    lib = libs("k4-slice-1024-claims-1" if variant == "other-blocks" else "k4-slice-1024")
    args = stream_cases.lay_out(cs, 17)
    pool = args[0].numel() // 1024 + len(cs) + 1
    capacity = 40 if variant == "small-table" else None
    ok, stats = check_k4(lib, cs, capacity=capacity, misalign=3 if variant == "unaligned-buffer" else 0,
                         blocks=pool + 2 if variant == "other-blocks" else 3,
                         pool=200 if variant == "few-slots" else 0)
    slices, met, walked = (int(v) for v in stats[4:7])
    # With 200 slots, the streams listed once they are taken are walked whole.
    assert (slices <= 200 if variant == "few-slots" else slices > 500) and 0 < met <= slices and 0 < walked <= slices
    if variant == "small-table":
        assert not ok[-1] and ok[0]
    else:
        assert ok.tolist() == [stream_cases.native_scan(c[1], c[2]) != "corrupt" for c in cs]


def test_k4_walks_the_slices_whose_chart_never_meets_the_stream(libs):
    ok, stats = check_k4(libs("k4-slice-256"), [never_meets()])
    slices, met, walked = (int(v) for v in stats[4:7])
    assert ok.all() and slices == -(-(len(never_meets()[1]) - 3) // 256)
    assert met < slices and walked > slices - met


def test_k4_slices_a_stream_only_past_the_threshold(libs):
    cs = [c for c in sliced_cases(256) if c[0].startswith("body-")]
    ok, stats = check_k4(libs("k4-slice-256"), cs)
    # Bodies of 256 bytes or less are walked whole; 257 and 512 take two
    # slices, 513 three.
    assert ok.all() and int(stats[4]) == 2 + 2 + 3
