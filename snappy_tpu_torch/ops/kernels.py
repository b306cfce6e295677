"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``.cu`` file exposes a plain C entry point that takes its pointers and
the stream as ``void*`` and returns the launch's ``cudaError_t``. Each file
is built into a library of its own, at first use into the package's build
directory, keyed by the source and flags, so an edited kernel rebuilds and
nothing else does. ``load(*stems)`` builds and loads only the sources it is
asked for (those not loaded yet by concurrent nvcc processes), so a wrapper
never waits for, or fails on, another kernel's source. Nothing is built or
imported when this module is imported.

A ``load`` that finds a source not loaded yet runs in the span
``kernels.load``, its builds in the child ``kernels.build``, and adds its
seconds (finding nvcc, hashing, nvcc, the dlopen) to ``kernels.load_s``.
"""

from __future__ import annotations

import ctypes
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..native.build import build_shared
from ..utils.profiling import count, trace_annotation

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_DECODE_ARGS = [_PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR]
# source stem -> {entry point: (restype, argtypes)}
ENTRIES = {
    "decode_blocks": {
        "snappy_cuda_decode_blocks": (_INT, _DECODE_ARGS),
        "snappy_cuda_decode_blocks_occupancy": (_INT, [_PTR, _PTR]),
        "snappy_cuda_decode_segments": (
            _INT, [_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _PTR, _I64, _PTR, _PTR, _PTR, _PTR]),
    },
    "segment_streams": {
        "snappy_cuda_segment_streams": (
            _INT, [_PTR, _I64, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                   _I64, _PTR]),
        "snappy_cuda_segment_streams_scratch": (_INT, [_I64, _I64, _PTR, _PTR, _PTR]),
        "snappy_cuda_segment_streams_occupancy": (_INT, [_PTR, _PTR]),
    },
    "encode_blocks": {
        "snappy_cuda_encode_blocks": (_INT, [_PTR, _PTR, _I64, _I64, _I64, _INT, _PTR, _PTR, _PTR]),
        "snappy_cuda_encode_blocks_occupancy": (_INT, [_I64, _PTR, _PTR]),
    },
    "decode_blocks_r4": {
        "snappy_cuda_decode_blocks_r4": (_INT, _DECODE_ARGS),
        "snappy_cuda_decode_blocks_r4_occupancy": (_INT, [_I64, _PTR, _PTR]),
    },
    # The probes P1-P6; each entry point ends with (cycles or null, stream).
    "exp_vector_walk": {
        "snappy_probe_chain": (_INT, [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_walk8": (_INT, [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_walk_scalar": (_INT, [_INT, _I64, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_drain": (_INT, [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_scalar_loop": (_INT, [_INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_when_drain": (_INT, [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_l2_read": (_INT, [_INT, _PTR, _PTR, _PTR, _PTR]),
    },
}

# stem -> its loaded library; (stems) -> the namespace load() gave for them
_libraries: dict[str, ctypes.CDLL] = {}
_namespaces: dict[tuple[str, ...], types.SimpleNamespace] = {}


def nvcc_path() -> Path:
    """The CUDA toolkit's nvcc, as PyTorch's extension builder finds it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the CUDA kernels cannot be built")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def load(*stems: str) -> types.SimpleNamespace:
    """The entry points of the sources ``stems`` as attributes of one
    namespace, with the libraries by stem in ``libraries``. Builds the
    sources not loaded yet, one nvcc each, all at once. Raises if a build
    fails or a stem is unknown."""
    ns = _namespaces.get(stems)
    if ns is not None:
        return ns
    unknown = [s for s in stems if s not in ENTRIES]
    if unknown:
        raise ValueError(f"no kernel source {unknown}; known: {list(ENTRIES)}")
    missing = [s for s in dict.fromkeys(stems) if s not in _libraries]
    if missing:
        t0 = time.perf_counter()
        with trace_annotation("kernels.load"):
            compiler = [str(nvcc_path()), *NVCC_FLAGS]
            with trace_annotation("kernels.build"), ThreadPoolExecutor(len(missing)) as pool:
                paths = list(pool.map(
                    lambda stem: build_shared(compiler, [CSRC / f"{stem}.cu"], f"snappy_cuda_{stem}"), missing
                ))
            for stem, path in zip(missing, paths):
                cdll = ctypes.CDLL(str(path))
                for name, (restype, argtypes) in ENTRIES[stem].items():
                    fn = getattr(cdll, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _libraries[stem] = cdll
        count("kernels.load_s", time.perf_counter() - t0)
    ns = types.SimpleNamespace(libraries={s: _libraries[s] for s in stems})
    for stem in stems:
        for name in ENTRIES[stem]:
            setattr(ns, name, getattr(_libraries[stem], name))
    _namespaces[stems] = ns
    return ns


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error, named by the CUDA runtime
    that torch links, so that no kernel source is needed for the message."""
    if rc != 0:
        cudart = torch.cuda.cudart()
        raise RuntimeError(f"{what}: CUDA error {rc} ({cudart.cudaGetErrorString(cudart.cudaError(rc))})")
