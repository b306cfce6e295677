"""ctypes bindings for the native C++ codec (``snappy_native.cpp``).

The host side of the port: the raw-format encoder, the batched headerless
block encoder, the reference decoder and ``scan_blocks``, the segmenter
that cuts a raw stream into block-decodable pieces; and ``crc32_rows``,
the crcs of many buffers in one call. A failed build or load raises;
``available()`` is the one probe, for the API's default backend.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from ..core.errors import CorruptInputError, InputTooLargeError, SnappyError
from . import build as _build

_OK = 0
_CORRUPT = 1
_TOO_LARGE = 3

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if sys.byteorder != "little":
        raise SnappyError("native codec requires a little-endian host")
    lib = ctypes.CDLL(str(_build.build()))
    lib.snappy_tpu_max_compressed_length.restype = ctypes.c_size_t
    lib.snappy_tpu_max_compressed_length.argtypes = [ctypes.c_size_t]
    lib.snappy_tpu_compress.restype = ctypes.c_int
    lib.snappy_tpu_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_compress_rows.restype = ctypes.c_int
    lib.snappy_tpu_compress_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    lib.snappy_tpu_uncompressed_length.restype = ctypes.c_int
    lib.snappy_tpu_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_uncompress.restype = ctypes.c_int
    lib.snappy_tpu_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_scan_blocks.restype = ctypes.c_int64
    lib.snappy_tpu_scan_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.snappy_tpu_torch_crc32_rows.restype = None
    lib.snappy_tpu_torch_crc32_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native codec builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError, SnappyError):
        return False
    return True


def _as_buffer(data) -> bytes:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.tobytes()
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)


def _check(rc: int) -> None:
    if rc == _OK:
        return
    if rc == _CORRUPT:
        raise CorruptInputError("corrupt snappy stream")
    if rc == _TOO_LARGE:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    raise SnappyError(f"native codec error {rc}")


def max_compressed_length(n: int) -> int:
    return _load().snappy_tpu_max_compressed_length(n)


def compress(data) -> bytes:
    """Raw Snappy stream (varint header + tag stream) of ``data``."""
    lib = _load()
    buf = _as_buffer(data)
    n = len(buf)
    out = ctypes.create_string_buffer(max_compressed_length(n))
    out_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_compress(buf, n, out, len(out), ctypes.byref(out_len)))
    return out.raw[: out_len.value]


def compress_rows(buf: np.ndarray, blens: np.ndarray, idx) -> list[bytes]:
    """Headerless tag streams for the selected rows of a (B, row_w) uint8
    block matrix, in one native call. Row ``idx[k]`` holds ``blens[idx[k]]``
    bytes of input."""
    lib = _load()
    idx64 = np.ascontiguousarray(np.asarray(idx, np.int64))
    k = len(idx64)
    if k == 0:
        return []
    buf = np.ascontiguousarray(buf, np.uint8)
    if buf.ndim != 2 or idx64.min() < 0 or idx64.max() >= buf.shape[0]:
        raise ValueError("compress_rows: bad block matrix or row index")
    lens32 = np.ascontiguousarray(np.asarray(blens, np.int32)[idx64])
    if lens32.min() < 0 or lens32.max() > buf.shape[1]:
        raise ValueError("compress_rows: block length outside its row")
    stride = int(lib.snappy_tpu_max_compressed_length(int(lens32.max())))
    out = np.empty((k, stride), np.uint8)
    out_lens = np.zeros(k, np.uint32)
    _check(
        lib.snappy_tpu_compress_rows(
            buf.ctypes.data, buf.shape[1], idx64.ctypes.data, lens32.ctypes.data,
            k, out.ctypes.data, stride, out_lens.ctypes.data,
        )
    )
    return [out[j, : out_lens[j]].tobytes() for j in range(k)]


def uncompressed_length(data) -> tuple[int, int]:
    """(uncompressed length, header length) of a raw stream."""
    lib = _load()
    buf = _as_buffer(data)
    result = ctypes.c_uint64()
    header_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_uncompressed_length(buf, len(buf), ctypes.byref(result), ctypes.byref(header_len)))
    return int(result.value), int(header_len.value)


def uncompress(data) -> bytes:
    """Decode a raw Snappy stream on the host."""
    lib = _load()
    buf = _as_buffer(data)
    ulen, _ = uncompressed_length(buf)
    out = ctypes.create_string_buffer(max(ulen, 1))
    out_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_uncompress(buf, len(buf), out, ulen, ctypes.byref(out_len)))
    return out.raw[: out_len.value]


def scan_blocks(body, ulen: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Segment a HEADERLESS tag stream for block-parallel decode.

    Segments start at the first tag boundary at or after every 64 KiB of
    output; segments are merged where a copy reaches behind its segment
    start. Returns (starts int64[n], oplens int32[n]), the input offsets
    and uncompressed lengths of the segments, or None when the stream
    cannot be cut into segments of at most 128 KiB of output. Raises
    CorruptInputError on streams the scan proves corrupt."""
    lib = _load()
    buf = _as_buffer(body)
    cap = (-(-ulen // (1 << 16)) if ulen else 0) + 1
    starts = np.zeros(cap, np.uint32)
    oplens = np.zeros(cap, np.uint32)
    rc = lib.snappy_tpu_scan_blocks(
        buf, len(buf), ulen,
        starts.ctypes.data_as(ctypes.c_void_p),
        oplens.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if rc == -1:
        return None
    if rc < 0:
        raise CorruptInputError("corrupt snappy stream")
    return starts[:rc].astype(np.int64), oplens[:rc].astype(np.int32)


def crc32_rows(ptrs: np.ndarray, lens: np.ndarray, out: np.ndarray) -> None:
    """``out[i]`` = ``zlib.crc32`` of the ``lens[i]`` bytes at address
    ``ptrs[i]`` (uint64, int64 and uint32 arrays of one length, contiguous),
    in one call that holds no interpreter lock. The caller keeps the
    buffers alive."""
    if not (ptrs.dtype == np.uint64 and lens.dtype == np.int64 and out.dtype == np.uint32
            and len(ptrs) == len(lens) == len(out)):
        raise TypeError("crc32_rows takes uint64 ptrs, int64 lens and uint32 out of one length")
    if not (ptrs.flags.c_contiguous and lens.flags.c_contiguous and out.flags.c_contiguous):
        raise ValueError("crc32_rows takes contiguous arrays")
    if (lens < 0).any():
        raise ValueError("negative buffer length")
    _load().snappy_tpu_torch_crc32_rows(ptrs.ctypes.data, lens.ctypes.data, len(ptrs), out.ctypes.data)
