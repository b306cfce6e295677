"""``tools/profile_decode.py`` on the CPU: its batches, its window rows and
its measurement through the plain version at a small size, and its
instrumented copy of this package's decoder source under the g++ emulation
of ``tests/test_torch_kernel_host.py``. Its anchors are checked with K2's
and K3's in ``tests/test_torch_kernel_profile.py``.

With ``clock64()`` a per-thread counter, the instrumented copy's tags,
literals and near and far copies must equal a walk of the same streams in
Python, its batches, table builds and the tags its chase placed from the
four-tag table and one at a time a model of the kernel's walk in Python
(``k1_batches``), its output the plain version's, and its timed phases must
add up to no more than the block's total. Tolerance: exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import decode_torch
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import kernel_profile, profile_encode
from snappy_tpu_torch.tools import profile_decode as tool

from conftest import read_testdata
from test_torch_kernel_host import PRELUDE, aligned_batch, build_emulation, emulation_source, run_emulation
from torch_helpers import native_body

SMALL = 4096

_PROFILE_PRELUDE = r"""
thread_local long long g_clock;
static inline long long clock64() { return ++g_clock; }
static inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
"""
_PROFILE_READ = r"""
extern "C" unsigned long long* emu_prof() { return g_prof; }
"""


@pytest.fixture(scope="module")
def small_batches():
    return tool.batches(mix_blocks=2, file_blocks=1, lineitem_blocks=3, n=SMALL, lineitem_n=SMALL)


def test_batches(small_batches):
    assert list(small_batches) == (["corpus mix, 2 blocks", "lineitem, 3 blocks of 4 KiB"]
                                   + [f"{n}, 1 blocks" for n in tool.FILES])
    for comp, clens, ulens, out_size in small_batches.values():
        assert out_size == SMALL and comp.dtype == np.uint8 and comp.shape[1] % 16 == 0
        assert clens.dtype == ulens.dtype == np.int32 and (ulens == SMALL).all()
        assert (clens > 0).all() and (clens + decode_torch.COMP_PAD <= comp.shape[1]).all()
    comp, clens, _, _ = small_batches["alice29.txt, 1 blocks"]
    raw = read_testdata("alice29.txt")[:SMALL]
    assert nat.uncompress(bytes(varint.encode32(SMALL)) + comp[0, : clens[0]].tobytes()) == raw
    comp, clens, _, _ = small_batches["lineitem, 3 blocks of 4 KiB"]
    rows = profile_encode.lineitem_rows(3, SMALL)
    for r in range(3):
        raw = rows[r * SMALL : (r + 1) * SMALL].tobytes()
        assert nat.uncompress(bytes(varint.encode32(SMALL)) + comp[r, : clens[r]].tobytes()) == raw


def test_measure_runs_the_plain_version(small_batches):
    """The tool's record for every batch, on the CPU: no cycles."""
    for label, (comp, clens, ulens, out_size) in small_batches.items():
        rec = tool.measure(label, comp, clens, ulens, out_size, torch.device("cpu"))
        assert rec["set"] == label and rec["blocks"] == len(clens) and rec["ms"] > 0
        assert rec["bytes"] == int(clens.sum()) and "phases" not in rec and tool.line(rec).startswith(label)


def test_window_rows_decode_to_their_bytes():
    """The rows at the window's and ring's edges, for this package's window
    and ring and for the smallest ones: the native decoder gives their
    bytes, none is over 128 KiB, and the copies reach the offsets named."""
    for window, ring in ((None, None), (256, 64)):
        rows = tool.window_rows(window, ring)
        assert list(rows) == [
            "copies-at-the-window-edge", "overlapping-copies", "literals-around-the-ring", "copy4-across-the-ring",
            "segment-128k", "text-across-flushes",
        ]
        for body, raw in rows.values():
            assert len(raw) <= 2 * tool.BLOCK
            assert nat.uncompress(bytes(varint.encode32(len(raw))) + body) == raw
        w = window or tool.window_bytes()
        offsets = {off for kind, off in walk(rows["copies-at-the-window-edge"][0]) if kind == "copy"}
        assert {w - 65, w - 64, w - 63, w - 1, w, w + 1} <= offsets
        lits = [n for kind, n in walk(rows["literals-around-the-ring"][0]) if kind == "literal"]
        assert lits == [20, (ring or tool.ring_bytes()) - 32, (ring or tool.ring_bytes()) - 31,
                        (ring or tool.ring_bytes()) + 100, 3 * (ring or tool.ring_bytes()) + 7, 5]


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the tool runs there")
    assert tool.main([]) == 2
    assert tool.main(["--bogus"]) == 2


def walk(body: bytes):
    """(kind, length or offset) of each tag of a valid stream: ("literal",
    n) or ("copy", offset)."""
    ip = 0
    while ip + 1 < len(body):
        c = body[ip]
        if c & 3 == 0:
            n = c >> 2
            k = n - 59 if n >= 60 else 0
            n = int.from_bytes(body[ip + 1 : ip + 1 + k], "little") if k else n
            yield "literal", n + 1
            ip += 1 + k + n + 1
        else:
            k = {1: 1, 2: 2, 3: 4}[c & 3]
            off = int.from_bytes(body[ip + 1 : ip + 1 + k], "little") + (((c >> 5) << 8) if c & 3 == 1 else 0)
            yield "copy", off
            ip += 1 + k


STOP = 0xFF


def _advance(c: int) -> int:
    """The step past a tag of byte c: its tag bytes, and a short literal's
    bytes; STOP for a literal with a length trailer."""
    if c & 3:
        return 1 + {1: 1, 2: 2, 3: 4}[c & 3]
    return (c >> 2) + 2 if c >> 2 < 60 else STOP


def k1_batches(body: bytes, ring: int, window: int, wide: bool) -> dict:
    """{count: n} of the windowed decoder's walk of one valid row, as its
    source walks it: the ring staged from the 16-byte chunk of the tag past
    it; the ring's step tables built from the walk's position at the first
    batch whose first tag the chase can take; a batch of up to 32 tags,
    four at a time by the four-tag table, then one at a time; a literal that
    ends a batch first moved alone, in pieces of at most the ring's rest and
    half a window. ``wide``: the row is read with 16-byte loads (its ring
    reaches the 16-byte chunk past the stream and its 4 bytes of padding)."""
    clen = len(body)
    in_end = (clen + 4 + 15) & ~15 if wide else clen + 4
    half = window // 2
    counts = {"table tags": 0, "single tags": 0, "batches": 0, "table builds": 0, "alone": 0}
    ip = rbase = rend = 0
    charted = None
    one = two = four = None

    def stage(at):
        base = at & ~15
        return base, min(base + ring, in_end)

    def doubled(table, lo, n):
        out = [STOP] * n
        for i in range(lo, n):
            a = table[i]
            b = table[i + a] if a != STOP and i + a < n else STOP
            out[i] = STOP if b == STOP else a + b
        return out

    while ip + 1 < clen:
        if ip + 5 > rend:
            rbase, rend = stage(ip)
        n = rend - rbase
        if charted != rbase:
            d = _advance(body[ip])
            if d != STOP and ip + d <= rend:
                one = [STOP] * n
                for i in range(ip - rbase, n):
                    q = rbase + i
                    d = _advance(body[q] if q < clen else 0)
                    one[i] = d if q + 1 < clen and q + 5 <= rend and d != STOP and q + d <= rend else STOP
                two = doubled(one, ip - rbase, n)
                four = doubled(two, ip - rbase, n)
                charted = rbase
                counts["table builds"] += 1
        nb = 0
        if charted == rbase:
            while nb + 4 <= 32 and ip < rend and four[ip - rbase] != STOP:
                ip += four[ip - rbase]
                nb += 4
            counts["table tags"] += nb
            while nb < 32 and ip < rend and one[ip - rbase] != STOP:
                ip += one[ip - rbase]
                nb += 1
                counts["single tags"] += 1
        if nb:
            counts["batches"] += 1
            continue
        # A literal alone.
        counts["alone"] += 1
        c = body[ip]
        k = (c >> 2) - 59 if c >> 2 >= 60 else 0
        m = int.from_bytes(body[ip + 1 : ip + 1 + k], "little") + 1 if k else (c >> 2) + 1
        s = ip + 1 + k
        ip = s + m
        if ip > rend:
            rbase, rend = stage(s)
        while True:
            piece = min(m, rend - s, half)
            s += piece
            m -= piece
            if m == 0:
                break
            if s == rend:
                rbase, rend = stage(s)
    return counts


@pytest.mark.parametrize("layout", ["window"])
def test_instrumented_copy_counts_the_tags(tmp_path, layout):
    src = kernel_profile.instrument((CSRC / "decode_blocks.cu").read_text(), tool.probes())
    emu_src = emulation_source(src)
    lib = build_emulation(tmp_path, emu_src.replace(PRELUDE, PRELUDE + _PROFILE_PRELUDE, 1) + _PROFILE_READ)
    lib.emu_prof.restype = ctypes.POINTER(ctypes.c_ulonglong)
    edge = tool.window_rows()
    lineitem = profile_encode.lineitem_rows(1, 1 << 15).tobytes()
    rows = [(native_body(read_testdata("alice29.txt")[:65536]), 65536), (native_body(b"q" * 5000), 5000)]
    rows += [(body, len(raw)) for body, raw in (edge["copies-at-the-window-edge"], edge["literals-around-the-ring"])]
    rows += [(native_body(lineitem), len(lineitem)), (native_body(read_testdata("fireworks.jpeg")[:65536]), 65536)]
    comp, clens, ulens = aligned_batch(rows)
    counts = lib.emu_prof()
    for i in range(tool.SLOTS):
        counts[i] = 0
    out, ok, total = run_emulation(lib, comp, clens, ulens, 1 << 17)
    p_out, p_ok, _ = decode_torch.decode_blocks(torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), 1 << 17)
    assert ok.all() and p_ok.numpy().all()
    np.testing.assert_array_equal(out, p_out.numpy())
    c = [counts[i] for i in range(tool.SLOTS)]
    tags = [t for body, _ in rows for t in walk(body)]
    near = tool.window_bytes() - tool.NEAR_MARGIN
    first = tool.TOTAL + 1
    assert c[first : first + 4] == [
        len(tags),
        sum(kind == "literal" for kind, _ in tags),
        sum(kind == "copy" and v <= near for kind, v in tags),
        sum(kind == "copy" and v > near for kind, v in tags),
    ]
    assert c[first + 2] > 0 and c[first + 3] > 0
    assert c[first + 4] > len(rows)  # stagings
    wide = comp.ctypes.data % 16 == 0
    want = [k1_batches(body, tool.ring_bytes(), tool.window_bytes(), wide) for body, _ in rows]
    names = ["table tags", "single tags", "batches", "table builds"]
    assert c[first + 5 : first + 9] == [sum(w[k] for w in want) for k in names]
    # Every tag is placed by the chase or moved alone.
    assert c[first + 5] + c[first + 6] + sum(w["alone"] for w in want) == len(tags)
    assert min(c[first + 5 : first + 9]) > 0
    assert c[tool.TOTAL] >= sum(c[: tool.TOTAL]) > 0
    phase = dict(zip(tool.PHASES, c))
    assert phase["flushes"] > 0 and phase["tables"] > 0 and phase["chase"] > 0
