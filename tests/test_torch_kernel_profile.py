"""``tools/kernel_profile.py``, the engine of the kernel profilers, and the
tools' corpus module, on the CPU.

Every probe of K1's, K2's and K3's tables (``profile_decode.probes``,
``profile_encode.PROBES``, ``profile_decode_r4.PROBES``) finds its anchor in
this package's ``csrc/`` source the number of times it states, and a copy of
the source with that anchor cut is refused by name. ``build`` runs with g++
standing in for nvcc: it binds the entry points of the stem and the
profiling ones that a text defines, and passes its defines. Tolerance: exact.
"""

import ctypes
import re
import shutil

import numpy as np
import pytest

from snappy_tpu_torch.native import build as native_build
from snappy_tpu_torch.ops import kernels
from snappy_tpu_torch.ops.kernels import CSRC
from snappy_tpu_torch.tools import corpus, kernel_profile, profile_decode, profile_decode_r4, profile_encode

from conftest import read_testdata

KERNELS = {
    "K1": ("decode_blocks", profile_decode.probes()),
    "K2": ("encode_blocks", profile_encode.PROBES),
    "K3": ("decode_blocks_r4", profile_decode_r4.PROBES),
}
CASES = [(k, i) for k, (_, probes) in KERNELS.items() for i in range(len(probes))]


@pytest.mark.parametrize("kernel,anchor", CASES, ids=[f"{k}-{i}" for k, i in CASES])
def test_instrument_finds_each_anchor_and_refuses_a_source_without_it(kernel, anchor):
    stem, probes = KERNELS[kernel]
    src = (CSRC / f"{stem}.cu").read_text()
    old, _, *times = probes[anchor]
    times = times[0] if times else 1
    assert src.count(old) == times
    assert "g_prof[" in kernel_profile.instrument(src, probes)
    cut = src.replace(old, old[: len(old) // 2] + "/**/" + old[len(old) // 2 :], 1)
    with pytest.raises(RuntimeError, match=re.escape(f"does not hold {old!r} {times} time(s)")):
        kernel_profile.instrument(cut, probes)


_ENTRY = r"""
#include <cstdint>
extern "C" {
int snappy_cuda_decode_blocks_r4(const void*, const void*, const void*, int64_t b, int64_t c, int64_t out_size,
                                 void*, void*, void*, void*) { return int(b + (c >> 40) + out_size); }
int snappy_cuda_decode_blocks_r4_occupancy(int64_t out_size, int* smem, int* blocks) {
  *smem = SMEM; *blocks = int(out_size >> 32); return 0;
}
"""
_PROF = r"""
static unsigned long long g_prof[2] = {7, 9};
int prof_read(unsigned long long* h) { h[0] = g_prof[0]; h[1] = g_prof[1]; return 0; }
int prof_reset() { g_prof[0] = g_prof[1] = 0; return 0; }
int prof_occupancy(int64_t row_c, int64_t out_size, int* smem, int* blocks) {
  *smem = int(row_c >> 32); *blocks = int(out_size >> 32); return 0;
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
def test_build_binds_the_entry_points_a_text_defines(tmp_path, monkeypatch):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: shutil.which("g++"))
    monkeypatch.setattr(kernels, "NVCC_FLAGS", ["-O1", "-shared", "-fPIC", "-x", "c++"])
    libs = kernel_profile.build("decode_blocks_r4", {
        "profile_engine_probed": _ENTRY + _PROF + "}\n", "profile_engine_timed": _ENTRY + "}\n",
    }, ["-DSMEM=4242"])
    assert sorted(p.name for p in tmp_path.glob("*.cu")) == ["profile_engine_probed.cu", "profile_engine_timed.cu"]
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    for lib in libs.values():
        assert lib.snappy_cuda_decode_blocks_r4(None, None, None, 1, 1 << 40, 3, None, None, None, None) == 5
        assert lib.snappy_cuda_decode_blocks_r4_occupancy(5 << 32, ctypes.byref(smem), ctypes.byref(blocks)) == 0
        assert (smem.value, blocks.value) == (4242, 5)
    probed = libs["profile_engine_probed"]
    counts = (ctypes.c_ulonglong * 2)()
    assert probed.prof_read(counts) == 0 and list(counts) == [7, 9]
    assert probed.prof_reset() == 0 and probed.prof_read(counts) == 0 and list(counts) == [0, 0]
    assert probed.prof_occupancy(3 << 32, 4 << 32, ctypes.byref(smem), ctypes.byref(blocks)) == 0
    assert (smem.value, blocks.value) == (3, 4)
    assert not hasattr(libs["profile_engine_timed"], "prof_read")


def test_corpus_stream_is_the_mix_in_turns():
    whole = b"".join(read_testdata(n) for n in corpus.MIX)
    assert corpus.corpus_stream(len(whole) + 1000) == whole + read_testdata(corpus.MIX[0])[:1000]
    assert corpus.repeat_to([b"ab", b"c"], 7) == b"abcabca"


def test_block_batch_packs_the_native_streams():
    comp, clens, ulens, out_size = corpus.block_batch(corpus.corpus_stream(3 * 4096 + 5), 4096)
    assert out_size == 4096 and comp.shape[0] == 3 and (ulens == 4096).all()
    assert comp.dtype == np.uint8 and clens.dtype == ulens.dtype == np.int32 and (clens <= comp.shape[1]).all()
