"""``tools/profile_encode.py`` on the CPU: its batches and its measurement
through the plain version at a small size, and its instrumented copy of the encoder
source under the g++ emulation of ``tests/test_torch_encode_kernel_host.py``.
Its anchors are checked with K1's and K3's in
``tests/test_torch_kernel_profile.py``.

The instrumented copy counts the takes its chase parses; here, with
``clock64()`` a per-thread counter, that count must equal the plain parse's
takes, the output must equal the plain version's, and the phases' spans
must add up to the total. Tolerance: exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import encode_torch, route
from snappy_tpu_torch.ops.encode_torch import ENC_PAD
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import kernel_profile
from snappy_tpu_torch.tools import profile_encode as tool

from conftest import read_testdata
from test_torch_encode_kernel_host import _PRELUDE, _batch, _emulation_source, build_emulation
from torch_helpers import plain_takes

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
    return tool.batches(mix_blocks=2, file_blocks=1, collision_rows=(1, 2), n=SMALL)


def test_batches(small_batches):
    labels = list(small_batches)
    assert labels[0].startswith("corpus mix, ") and labels[0].endswith(" device blocks of 2")
    assert labels[1:] == [f"{n}, 1 blocks" for n in tool.FILES] + ["collision, 1 blocks", "collision, 2 blocks"]
    for blocks, blens in small_batches.values():
        assert blocks.shape == (len(blens), SMALL + ENC_PAD) and blocks.dtype == np.uint8 and blens.dtype == np.int32
        assert (blens > 0).all() and (blens <= SMALL).all()
    blocks, blens = small_batches["collision, 2 blocks"]
    # Blocks of SMALL bytes go to the 32 KiB variant: keys share its 13-bit hash.
    assert tool.variant_bits(SMALL) == 15
    assert (blocks[0] == blocks[1]).all() and blocks[0, :SMALL].tobytes() == tool.collision_block(SMALL, bits=13)


def test_narrow_batches():
    """The 32 KiB variant's batches at a small size: the corpus mix cut to
    the block size, the benchmark's lineitem rows (their 4-byte row sizes
    big-endian, as Spark writes them), the collision rows."""
    got = tool.narrow_batches(mix_blocks=2, lineitem_blocks=3, collision_rows=(1,), n=SMALL)
    labels = list(got)
    assert labels[0].startswith("corpus mix cut to 4 KiB, ") and labels[0].endswith(" device blocks of 2")
    assert labels[1:] == ["lineitem, 3 blocks of 4 KiB", "collision of 4 KiB, 1 blocks"]
    for blocks, blens in got.values():
        assert blocks.shape == (len(blens), SMALL + ENC_PAD) and (blens == SMALL).all()
    rows, _ = got["lineitem, 3 blocks of 4 KiB"]
    size = int.from_bytes(rows[0, :4].tobytes(), "big")
    assert 100 < size < 400 and len(rows) == 3
    assert tool.lineitem_rows(3, SMALL).tobytes() == rows[:, :SMALL].tobytes()


def test_measure_runs_the_plain_version(small_batches):
    """The tool's record for every batch, on the CPU: no cycles; the
    collision block is one that routing sends to the host."""
    for label, (blocks, blens) in small_batches.items():
        rec = tool.measure(label, blocks, blens, torch.device("cpu"))
        assert rec["set"] == label and rec["blocks"] == len(blens) and rec["ms"] > 0
        assert rec["bytes"] == int(blens.sum()) and 0 < rec["out_bytes"]
        assert "phases" not in rec and tool.line(rec).startswith(label)
        assert rec["routed_to_host"] == (1 if label.startswith("collision") else None)


def test_the_collision_block_routes_to_the_host_at_full_size():
    row = tool.collision_block()
    buf = np.zeros((1, len(row) + ENC_PAD), np.uint8)
    buf[0, : len(row)] = np.frombuffer(row, np.uint8)
    assert route.dup_ratios(buf, np.array([len(row)], np.int32), 1)[0] == 0.0
    assert route.host_blocks(buf, np.array([len(row)], np.int32)).tolist() == [0]


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the tool runs there")
    assert tool.main([]) == 2
    assert tool.main(["--bogus"]) == 2


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    src = kernel_profile.instrument((CSRC / "encode_blocks.cu").read_text(), tool.PROBES)
    emu_src = _emulation_source(src).replace(_PRELUDE, _PRELUDE + _PROFILE_PRELUDE, 1) + _PROFILE_READ
    run, lib = build_emulation(tmp_path_factory.mktemp("encode_profiled_host"), emu_src)
    lib.emu_prof.restype = ctypes.POINTER(ctypes.c_ulonglong)
    return run, lib


def test_instrumented_copy_counts_the_takes(profiled):
    """In both variants: 64 KiB rows and 32 KiB rows."""
    run, lib = profiled
    for block in (65536, 32768):
        rows = [read_testdata("alice29.txt")[:block], read_testdata("html")[:20000], b"q" * 5000, b"",
                tool.literals_across_chunks(block)]
        blocks, blens = _batch(rows, block + ENC_PAD)
        counts = lib.emu_prof()
        for i in range(8):
            counts[i] = 0
        out, olens = run(blocks, blens, 2)
        p_out, p_olens = encode_torch.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(blens), 2)
        np.testing.assert_array_equal(olens, p_olens.numpy())
        np.testing.assert_array_equal(out, p_out.numpy())
        c = [counts[i] for i in range(8)]
        assert c[tool.TAKES] == sum(len(plain_takes(r, 2)) for r in rows)
        assert c[tool.TOTAL] >= sum(c[: len(tool.PHASES)]) > 0
        assert all(v > 0 for v in c[: len(tool.PHASES)])
