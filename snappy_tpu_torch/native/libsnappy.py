"""ctypes binding to the real google/snappy C library.

The port's own copy of ``snappy_tpu/native/libsnappy.py``: the four-function
C API of snappy-c.h (reference test/libsnappy.jl:5-30), so that density and
wire-compatibility gates check against the genuine article rather than the
repository's own C++ encoder. ``available()`` is False where the system has
no libsnappy; callers then skip those gates and say so.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

_CANDIDATES = ("libsnappy.so.1", "libsnappy.so", "libsnappy.1.dylib", "libsnappy.dylib")


@lru_cache(maxsize=1)
def _lib():
    names = list(_CANDIDATES)
    found = ctypes.util.find_library("snappy")
    if found:
        names.append(found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.snappy_max_compressed_length.restype = ctypes.c_size_t
        lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
        lib.snappy_compress.restype = ctypes.c_int
        lib.snappy_compress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompressed_length.restype = ctypes.c_int
        lib.snappy_uncompressed_length.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.snappy_uncompress.restype = ctypes.c_int
        lib.snappy_uncompress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        return lib
    return None


def available() -> bool:
    return _lib() is not None


def max_compressed_length(n: int) -> int:
    return int(_lib().snappy_max_compressed_length(n))


def compress(data: bytes) -> bytes:
    """Compress with the real libsnappy (reference test/libsnappy.jl:7-13)."""
    lib = _lib()
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    rc = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"snappy_compress failed: {rc}")
    return out.raw[: out_len.value]


def uncompress(data: bytes) -> bytes:
    """Decompress with the real libsnappy (reference test/libsnappy.jl:16-27).

    Raises ValueError on corrupt input (snappy_status != 0), mirroring the
    C API's SNAPPY_INVALID_INPUT.
    """
    lib = _lib()
    n = ctypes.c_size_t(0)
    rc = lib.snappy_uncompressed_length(data, len(data), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"snappy_uncompressed_length failed: {rc}")
    out = ctypes.create_string_buffer(max(n.value, 1))
    out_len = ctypes.c_size_t(n.value)
    rc = lib.snappy_uncompress(data, len(data), out, ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"snappy_uncompress failed: {rc}")
    return out.raw[: out_len.value]
