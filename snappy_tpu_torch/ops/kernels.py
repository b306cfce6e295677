"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``.cu`` file exposes a plain C entry point that takes its pointers and
the stream as ``void*`` and returns the launch's ``cudaError_t``. The
library is built at first use into the package's build directory, keyed by
the sources and flags, so an edited kernel rebuilds and nothing else does.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..native.build import build_shared

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

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
    """The kernel library, building it if needed. Raises if the build fails."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    lib = ctypes.CDLL(str(build_shared([str(nvcc_path()), *NVCC_FLAGS], sources, "snappy_cuda")))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.snappy_cuda_decode_blocks.restype = ctypes.c_int
    lib.snappy_cuda_decode_blocks.argtypes = [ptr, ptr, ptr, i64, i64, i64, ptr, ptr, ptr, ptr]
    lib.snappy_cuda_encode_blocks.restype = ctypes.c_int
    lib.snappy_cuda_encode_blocks.argtypes = [ptr, ptr, i64, i64, i64, ctypes.c_int, ptr, ptr, ptr]
    lib.snappy_cuda_error_string.restype = ctypes.c_char_p
    lib.snappy_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = load().snappy_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
