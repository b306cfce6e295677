"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``.cu`` file exposes a plain C entry point that takes its pointers and
the stream as ``void*`` and returns the launch's ``cudaError_t``. Each file
is built into a library of its own, all of them by concurrent nvcc
processes, at first use into the package's build directory, keyed by the
source and flags, so an edited kernel rebuilds and nothing else does.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..native.build import build_shared

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
        "snappy_cuda_error_string": (ctypes.c_char_p, [_INT]),
    },
    "encode_blocks": {
        "snappy_cuda_encode_blocks": (_INT, [_PTR, _PTR, _I64, _I64, _I64, _INT, _PTR, _PTR, _PTR]),
    },
    "decode_blocks_r4": {
        "snappy_cuda_decode_blocks_r4": (_INT, _DECODE_ARGS),
    },
    # The probes P1-P6; each entry point ends with (cycles or null, stream).
    "exp_vector_walk": {
        "snappy_probe_chain": (_INT, [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_walk8": (_INT, [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_walk_scalar": (_INT, [_INT, _I64, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_drain": (_INT, [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_scalar_loop": (_INT, [_INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR]),
        "snappy_probe_when_drain": (_INT, [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]),
    },
}

_lib = None


def nvcc_path() -> Path:
    """The CUDA toolkit's nvcc, as PyTorch's extension builder finds it."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); the CUDA kernels cannot be built")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def load():
    """Every kernel's entry points as attributes of one namespace, building
    the libraries if needed (all sources at once). Raises if a build fails."""
    global _lib
    if _lib is not None:
        return _lib
    compiler = [str(nvcc_path()), *NVCC_FLAGS]
    with ThreadPoolExecutor(len(ENTRIES)) as pool:
        paths = dict(zip(ENTRIES, pool.map(
            lambda stem: build_shared(compiler, [CSRC / f"{stem}.cu"], f"snappy_cuda_{stem}"), ENTRIES
        )))
    lib = types.SimpleNamespace(libraries={})
    for stem, entries in ENTRIES.items():
        cdll = ctypes.CDLL(str(paths[stem]))
        lib.libraries[stem] = cdll
        for name, (restype, argtypes) in entries.items():
            fn = getattr(cdll, name)
            fn.restype, fn.argtypes = restype, argtypes
            setattr(lib, name, fn)
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = load().snappy_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
