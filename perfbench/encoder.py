"""The frozen greedy encoder that writes the decode cells' streams.

``native/snappy_native.cpp`` is a copy of the program's C++ codec taken
when this benchmark was written and never edited since, so the streams a
decode cell reads do not move when the program's encoders change. It is
built once with g++ into ``_build/`` beside this file, keyed by the source
and flags, and called through ctypes, rows split over a few threads.

``control=True`` builds the same source with one line changed: the scan
takes the hash table's candidate without comparing its four bytes, as an
encoder that trusted its hash would. Its streams are valid Snappy that
decode to the wrong bytes wherever two keys collide; it is the encode
cells' control (``control.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "native" / "snappy_native.cpp"
BUILD_DIR = HERE / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fno-exceptions", "-fno-rtti"]
VERIFY_LINE = b"        if (Load32(in + candidate) == Load32(in + ip)) break;\n"
TRUST_LINE = b"        break;\n"
THREADS = 8

_libs: dict[bool, ctypes.CDLL] = {}


def max_compressed_length(n: int) -> int:
    """The source's bound on one block's stream (``snappy_tpu_max_compressed_length``)."""
    return 32 + n + n // 6


def _source(control: bool) -> bytes:
    src = SOURCE.read_bytes()
    if not control:
        return src
    if src.count(VERIFY_LINE) != 1:
        raise RuntimeError(f"{SOURCE} no longer holds the candidate check the control removes")
    return src.replace(VERIFY_LINE, TRUST_LINE)


def build(control: bool = False) -> Path:
    """The library's path, compiled first where it is not built yet."""
    src = _source(control)
    cmd = ["g++", *CXXFLAGS, "-x", "c++", "-"]
    key = hashlib.sha256(" ".join(cmd).encode() + src).hexdigest()[:16]
    lib = BUILD_DIR / f"snappy_encoder{'_control' if control else ''}-{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], input=src, capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr.decode(errors='replace')}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _load(control: bool) -> ctypes.CDLL:
    if control not in _libs:
        cdll = ctypes.CDLL(str(build(control)))
        fn = cdll.snappy_tpu_compress_rows
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_size_t, p, p, ctypes.c_size_t, p, ctypes.c_size_t, p]
        fn.restype = ctypes.c_int
        _libs[control] = cdll
    return _libs[control]


def compress_rows(blocks: np.ndarray, lens: np.ndarray, width: int, control: bool = False):
    """Headerless streams of the rows of ``blocks`` (u8[N, W], ``lens[i]``
    bytes of row i) as (u8[N, width] zero past each stream, i32[N])."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n = len(blocks)
    if n and max_compressed_length(int(lens.max())) > width:
        raise ValueError(f"rows of {int(lens.max())} bytes need a width of {max_compressed_length(int(lens.max()))}")
    fn = _load(control).snappy_tpu_compress_rows
    out = np.zeros((n, width), dtype=np.uint8)
    olens = np.zeros(n, dtype=np.uint32)
    idx = np.arange(n, dtype=np.int64)
    parts = np.array_split(np.arange(n), min(THREADS, max(n, 1)))

    def run(part):
        if not len(part):
            return 0
        lo, k = int(part[0]), len(part)
        return fn(blocks.ctypes.data, blocks.shape[1], idx[lo:].ctypes.data, lens[lo:].ctypes.data, k,
                  out[lo:].ctypes.data, width, olens[lo:].ctypes.data)

    with ThreadPoolExecutor(len(parts)) as pool:
        rcs = list(pool.map(run, parts))
    if any(rcs):
        raise RuntimeError(f"snappy_tpu_compress_rows returned {rcs}")
    return out, olens.astype(np.int32)
