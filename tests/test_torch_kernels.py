"""``ops/kernels.py`` on the CPU: ``load(*stems)`` builds and loads only the
sources it is asked for, and ``check`` names an error without any kernel
source.

There is no nvcc here, so ``build_shared`` is stubbed: it compiles, with
g++, a stand-in library that defines the asked source's entry points (each
returns its source's index), and records which sources it was asked for.
"""

import contextlib
import subprocess
import types

import pytest

from snappy_tpu_torch.ops import kernels

STEMS = list(kernels.ENTRIES)


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    """A fresh loader whose builds are g++ stand-ins; yields the list of
    sources built, in order."""
    built = []

    def build_shared(compiler, sources, stem):
        (src,) = sources
        assert src == kernels.CSRC / f"{src.stem}.cu" and src.exists()
        assert stem == f"snappy_cuda_{src.stem}"
        built.append(src.stem)
        index = STEMS.index(src.stem)
        body = "".join(f'extern "C" int {name}() {{ return {index}; }}\n' for name in kernels.ENTRIES[src.stem])
        cpp, so = tmp_path / f"{src.stem}.cpp", tmp_path / f"{src.stem}.so"
        cpp.write_text(body)
        subprocess.run(["g++", "-shared", "-fPIC", str(cpp), "-o", str(so)], check=True)
        return so

    monkeypatch.setattr(kernels, "build_shared", build_shared)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kernels, "_libraries", {})
    monkeypatch.setattr(kernels, "_namespaces", {})
    yield built


@pytest.mark.parametrize("stem", STEMS)
def test_load_builds_only_the_asked_source(stub_build, stem):
    lib = kernels.load(stem)
    assert stub_build == [stem]
    assert list(lib.libraries) == [stem]
    names = [n for n in vars(lib) if n != "libraries"]
    assert names == list(kernels.ENTRIES[stem])
    for name, (restype, argtypes) in kernels.ENTRIES[stem].items():
        fn = getattr(lib, name)
        assert fn.restype is restype and fn.argtypes == argtypes
    # Loaded once: a second call builds nothing and gives the same namespace.
    assert kernels.load(stem) is lib and stub_build == [stem]


def test_load_adds_only_the_sources_not_loaded_yet(stub_build):
    kernels.load("encode_blocks")
    lib = kernels.load(*STEMS)
    assert sorted(stub_build) == sorted(STEMS) and stub_build[0] == "encode_blocks"
    assert len(stub_build) == len(set(stub_build))
    assert list(lib.libraries) == STEMS
    for stem, entries in kernels.ENTRIES.items():
        for name in entries:
            assert hasattr(lib, name)
    assert kernels.load("decode_blocks", "decode_blocks_r4").libraries.keys() == {"decode_blocks", "decode_blocks_r4"}
    assert len(stub_build) == len(STEMS)


def test_load_refuses_an_unknown_source(stub_build):
    with pytest.raises(ValueError, match="no kernel source"):
        kernels.load("encode_blocks", "nope")
    assert stub_build == []


def test_the_wrappers_ask_for_their_own_source(stub_build, monkeypatch):
    """Each wrapper's launch goes to an entry of its own source and builds
    nothing else; the stand-in entry returns the source's index, which
    ``check`` then sees."""
    import torch

    from snappy_tpu_torch.ops import cuda_decode, cuda_encode, cuda_probes

    seen = []
    monkeypatch.setattr(kernels, "check", lambda rc, what: seen.append(STEMS[rc]))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    t = torch.zeros(1, 16, dtype=torch.uint8)
    n = torch.zeros(1, dtype=torch.int32)
    cuda_encode.launch(t, n, 2)
    cuda_decode.launch("decode_blocks", "snappy_cuda_decode_blocks", t, n, n, 16)
    cuda_decode.launch("decode_blocks_r4", "snappy_cuda_decode_blocks_r4", t, n, n, 16)
    cuda_probes._launch("chain", "snappy_probe_chain", "cpu", None, 0, 0, 0, None, None)
    order = ["encode_blocks", "decode_blocks", "decode_blocks_r4", "exp_vector_walk"]
    assert seen == order and stub_build == order


def test_check_names_the_error_by_the_cuda_runtime(monkeypatch):
    kernels.check(0, "never raises")
    fake = types.SimpleNamespace(cudaError=lambda rc: ("err", rc), cudaGetErrorString=lambda e: f"name of {e[1]}")
    monkeypatch.setattr(kernels.torch.cuda, "cudart", lambda: fake)
    with pytest.raises(RuntimeError, match=r"encode launch: CUDA error 700 \(name of 700\)"):
        kernels.check(700, "encode launch")
