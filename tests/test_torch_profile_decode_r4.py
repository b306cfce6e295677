"""``tools/profile_decode_r4.py`` on the CPU: its source rewriting, and its
instrumented copy of K3 under the g++ emulation of
``tests/test_torch_decode_r4_kernel_host.py``.

Every anchor's replacement is in the instrumented source (its anchors are
checked with K1's and K2's in ``tests/test_torch_kernel_profile.py``), and
the instrumented source still compiles and decodes under the emulation, in
both of the launcher's variants. There, with
``clock64()`` a per-thread counter, its tallies must equal those of the
walk as the kernel keeps it (tags, records, copy groups and the
groups the walker flags, ``r4_records``), every phase must have run, and
its output must equal the plain version's. Tolerance: exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import kernel_profile
from snappy_tpu_torch.tools import profile_decode_r4 as tool

from conftest import read_testdata
from test_torch_decode_r4_kernel_host import (
    MODES,
    _PRELUDE,
    _assert_same,
    _emulation_source,
    _plain,
    _plain_bytes,
    build_emulation,
    r4_records,
)
from torch_helpers import copy1, copy2, lit, native_body, odd_width_batch

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


def _source() -> str:
    return (CSRC / "decode_blocks_r4.cu").read_text()


def test_instrument_finds_every_anchor():
    src = kernel_profile.instrument(_source(), tool.PROBES)
    assert src.count("clock64()") >= 10 and "prof_occupancy" in src and "g_prof[16]" in src
    for old, new in tool.PROBES:
        assert new in src


def test_tally_per_block_and_per_record():
    counts = [0] * 16
    for k, v in {"walk": 9000, "total": 20000, "tags": 120, "records": 100, "groups": 8, "flagged groups": 2,
                 "literals": 400, "blocks": 2}.items():
        counts[tool.SLOTS[k]] = v
    t = tool.tally(counts, 2)
    assert t["per_block"] == {"tags": 60, "records": 50, "groups": 4, "flagged groups": 1}
    assert t["cycles_per_block"] == 10000 and t["cycles_per_record"]["walk"] == 90
    assert t["walk_cycles_per_tag"] == 75 and t["cycles_per_record"]["literals"] == 4


def test_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the tool runs there")
    assert tool.main([]) == 2
    assert tool.main(["--bogus"]) == 2


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    src = kernel_profile.instrument(_source(), tool.PROBES)
    emu_src = _emulation_source(src).replace(_PRELUDE, _PRELUDE + _PROFILE_PRELUDE, 1) + _PROFILE_READ
    run, lib = build_emulation(tmp_path_factory.mktemp("decode_r4_profiled_host"), emu_src)
    lib.emu_prof.restype = ctypes.POINTER(ctypes.c_ulonglong)
    return run, lib


def _rows():
    base = bytes(np.random.default_rng(9).integers(0, 256, 600, dtype=np.uint8))
    far = b"".join(lit(base[i : i + 60]) for i in range(0, 600, 60)) + b"".join(copy2(8, 200 + 3 * k) for k in range(40))
    near = lit(base[:60]) + b"".join(copy1(4 + k % 8, 1 + k % 3) for k in range(40))
    text = read_testdata("alice29.txt")[:65536]
    html = read_testdata("html")[:30000]
    folds = lit(b"ab") + (copy2(64, 2) + copy2(20, 2)) * 300
    return [native_body(text), native_body(html), far + near, folds]


@pytest.mark.parametrize("mode", list(MODES.values()), ids=list(MODES))
def test_instrumented_copy_counts_the_walk(profiled, mode):
    run, lib = profiled
    n, group = lib.emu_chunk(), lib.emu_group()
    bodies = _rows()
    comp, clens, ulens = odd_width_batch([(b, len(_plain_bytes(b, None))) for b in bodies])
    counts = lib.emu_prof()
    for i in range(16):
        counts[i] = 0
    got = run(comp, clens, ulens, 1 << 16, mode)
    want = _plain(comp, clens, ulens, 1 << 16)
    assert want[1].all()
    _assert_same(got, want)
    c = {k: counts[i] for k, i in tool.SLOTS.items()}
    model = [r4_records(b, n, group) for b in bodies]
    for k in ("tags", "records", "groups"):
        assert c[k] == sum(m[k] for m in model), k
    assert c["flagged groups"] == sum(m["flagged"] for m in model) > 0
    assert c["records"] == c["tags"] and c["blocks"] == len(bodies)
    for ph in tool.PHASES:
        assert c[ph] > 0, ph
