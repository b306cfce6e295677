"""Varint32 framing: the uncompressed-length prefix of every Snappy stream.

LEB128-style little-endian base-128 varint, at most 5 bytes
(behavioural contract: reference src/varint.jl:12-69 — unrolled there,
loop-form here; same bounds/overflow conditions byte for byte).
"""

from __future__ import annotations

from .constants import MAX_VARINT32_BYTES
from .errors import CorruptInputError


def parse32(buf, offset: int = 0) -> tuple[int, int]:
    """Parse a varint32 at ``buf[offset:]``.

    Returns ``(value, end_offset)`` where ``end_offset`` is one past the last
    varint byte. Raises :class:`CorruptInputError` on truncation, on a varint
    longer than 5 bytes, and on 32-bit overflow in the 5th byte
    (reference src/varint.jl:12-37: the 5th byte must be < 0x10).
    """
    n = len(buf)
    result = 0
    for i in range(MAX_VARINT32_BYTES):
        if offset >= n:
            raise CorruptInputError("could not decode varint32: truncated")
        b = int(buf[offset])
        offset += 1
        if i == MAX_VARINT32_BYTES - 1:
            if b < 0x10:
                return result | (b << 28), offset
            raise CorruptInputError("could not decode varint32: overflow")
        result |= (b & 0x7F) << (7 * i)
        if b < 0x80:
            return result, offset
    raise CorruptInputError("could not decode varint32")


def encode32(value: int) -> bytes:
    """Encode ``value`` (< 2**32) as a varint32 byte string."""
    if not 0 <= value < (1 << 32):
        raise ValueError(f"varint32 out of range: {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encoded_length(value: int) -> int:
    """Number of bytes ``encode32(value)`` produces."""
    n = 1
    while value >= 0x80:
        value >>= 7
        n += 1
    return n
