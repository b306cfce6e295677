"""``tools/profile_decode.py`` on the CPU: its batches, its window rows and
its measurement through the plain version at a small size, and its
instrumented copies of both decoder layouts under the g++ emulation of
``tests/test_torch_kernel_host.py``: this package's windowed source and the
staged one before it (``tests/data/decode_blocks_staged.cu``).

With ``clock64()`` a per-thread counter, the instrumented copy's tags,
literals and near and far copies must equal a walk of the same streams in
Python, its output the plain version's, and its timed phases must add up to
no more than the block's total. Tolerance: exact.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import decode_torch
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import profile_decode as tool

from conftest import read_testdata
from test_torch_kernel_host import HARNESS, PRELUDE, aligned_batch, build_emulation, emulation_source, run_emulation
from torch_helpers import native_body

SMALL = 4096
STAGED = Path(__file__).parent / "data" / "decode_blocks_staged.cu"

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
_STAGED_SUBSTITUTIONS = [
    ("#include <cuda_runtime.h>", ""),
    ("extern __shared__ __align__(16) uint8_t smem[];", "uint8_t* smem = g_smem;"),
]


@pytest.fixture(scope="module")
def small_batches():
    return tool.batches(mix_blocks=2, file_blocks=1, n=SMALL)


def test_batches(small_batches):
    assert list(small_batches) == ["corpus mix, 2 blocks"] + [f"{n}, 1 blocks" for n in tool.FILES]
    for comp, clens, ulens, out_size in small_batches.values():
        assert out_size == SMALL and comp.dtype == np.uint8 and comp.shape[1] % 16 == 0
        assert clens.dtype == ulens.dtype == np.int32 and (ulens == SMALL).all()
        assert (clens > 0).all() and (clens + decode_torch.COMP_PAD <= comp.shape[1]).all()
    comp, clens, _, _ = small_batches["alice29.txt, 1 blocks"]
    raw = read_testdata("alice29.txt")[:SMALL]
    assert nat.uncompress(bytes(varint.encode32(SMALL)) + comp[0, : clens[0]].tobytes()) == raw


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


def test_instrument_knows_both_layouts():
    src = (CSRC / "decode_blocks.cu").read_text()
    assert tool.layout_of(src) == "window" and tool.instrument(src)[0] == "window"
    assert tool.instrument(STAGED.read_text())[0] == "staged"
    with pytest.raises(RuntimeError, match="does not hold"):
        tool.instrument(src.replace("      const uint4 r = next_rec;\n", "      const uint4 r(next_rec);\n"))
    with pytest.raises(RuntimeError, match="3 time"):
        tool.instrument(src.replace("stage(ring, src, ", "stage(ring, src,", 1))
    with pytest.raises(RuntimeError, match="does not hold"):
        tool.instrument(STAGED.read_text().replace("      op += len;\n", "      op = op + len;\n"))


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


def _staged_emulation_source(src: str) -> str:
    src = src[: src.index('extern "C" {')]
    for old, new in _STAGED_SUBSTITUTIONS:
        assert src.count(old) == 1, f"staged source no longer holds {old!r}"
        src = src.replace(old, new)
    harness = HARNESS.replace("decode_blocks_kernel(", "decode_blocks_kernel<true>(")
    return PRELUDE + "alignas(16) static uint8_t g_smem[1 << 20];\n" + src + harness


@pytest.mark.parametrize("layout", ["window", "staged"])
def test_instrumented_copy_counts_the_tags(tmp_path, layout):
    text = (CSRC / "decode_blocks.cu").read_text() if layout == "window" else STAGED.read_text()
    got_layout, src = tool.instrument(text)
    assert got_layout == layout
    emu_src = emulation_source(src) if layout == "window" else _staged_emulation_source(src)
    lib = build_emulation(tmp_path, emu_src.replace(PRELUDE, PRELUDE + _PROFILE_PRELUDE, 1) + _PROFILE_READ)
    lib.emu_prof.restype = ctypes.POINTER(ctypes.c_ulonglong)
    edge = tool.window_rows()
    rows = [(native_body(read_testdata("alice29.txt")[:65536]), 65536), (native_body(b"q" * 5000), 5000)]
    rows += [(body, len(raw)) for body, raw in (edge["copies-at-the-window-edge"], edge["literals-around-the-ring"])]
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
    stagings = c[first + 4]
    assert stagings > len(rows) if layout == "window" else stagings == len(rows)
    assert c[tool.TOTAL] >= sum(c[: tool.TOTAL]) > 0
    assert (c[4] > 0) == (layout == "window")  # flushes
