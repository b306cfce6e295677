"""CPU oracle codec: a scalar NumPy implementation of the Snappy format.

The port's own copy of ``snappy_tpu/cpu/oracle.py``, behind the API's
``"cpu"`` backend. It reproduces the behaviour of libsnappy's greedy LZ77
parse (hash-probe scan with heuristic match skipping, literal and copy
emission, 64-byte copy chunking), so its compressed sizes track the native
encoder's, and its decoder enforces exactly the reference's corruption
checks (reference src/internal.jl:127-250 encode, :411-527 decode).

Performance is not a goal here (``native/runtime.py`` is the C++ codec, the
CUDA kernels the device path).
"""

from __future__ import annotations

import numpy as np

from ..core import varint
from ..core.constants import (
    BLOCK_SIZE,
    CHAR_TABLE,
    HASH_MULTIPLIER,
    INPUT_MARGIN_BYTES,
    LITERAL,
    WORDMASK,
    hash_table_size,
    max_compressed_length,
)
from ..core.errors import CorruptInputError, InputTooLargeError

_U32 = 0xFFFFFFFF


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data
    if isinstance(data, str):
        data = data.encode("utf-8")
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _load32(a: np.ndarray, i: int) -> int:
    # Little-endian 4-byte load; callers guarantee i+4 <= len(a).
    return int(a[i]) | (int(a[i + 1]) << 8) | (int(a[i + 2]) << 16) | (int(a[i + 3]) << 24)


def _hash(u32: int, shift: int) -> int:
    return ((u32 * HASH_MULTIPLIER) & _U32) >> shift


def _find_match_length(a: np.ndarray, i1: int, i2: int, limit: int) -> int:
    """Length of the longest common prefix of a[i1:] and a[i2:], capped so no
    byte at or beyond ``limit`` is read on the i2 side (behavioural contract:
    reference src/internal.jl:332-408)."""
    max_m = limit - i2
    if max_m <= 0:
        return 0
    neq = np.flatnonzero(a[i1 : i1 + max_m] != a[i2 : i2 + max_m])
    return int(neq[0]) if neq.size else max_m


def _emit_literal(out: bytearray, data: np.ndarray, start: int, length: int) -> None:
    n = length - 1
    if n < 60:
        out.append(LITERAL | (n << 2))
    else:
        extra = bytearray()
        v = n
        while v > 0:
            extra.append(v & 0xFF)
            v >>= 8
        out.append(LITERAL | ((59 + len(extra)) << 2))
        out += extra
    out += data[start : start + length].tobytes()


def _emit_copy_upto64(out: bytearray, offset: int, length: int) -> None:
    if length < 12 and offset < 2048:
        out.append(0x01 | ((length - 4) << 2) | (((offset >> 8) & 0x07) << 5))
        out.append(offset & 0xFF)
    else:
        out.append(0x02 | ((length - 1) << 2))
        out.append(offset & 0xFF)
        out.append((offset >> 8) & 0xFF)


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # Chunk long matches into <=64-byte copies, keeping >=4 for the last one
    # (reference src/internal.jl:306-329).
    while length >= 68:
        _emit_copy_upto64(out, offset, 64)
        length -= 64
    if length > 64:
        _emit_copy_upto64(out, offset, 60)
        length -= 60
    _emit_copy_upto64(out, offset, length)


def _compress_block(inp: np.ndarray, ip: int, ip_end: int, table: np.ndarray, shift: int, out: bytearray) -> None:
    """Greedy-parse one block [ip, ip_end) and append its tag stream to out.

    Mirrors libsnappy's scan loop: multiplicative hash probes with the
    32-miss skip heuristic, then copy extension with double table update
    (behavioural contract: reference src/internal.jl:127-250)."""
    base_ip = ip
    next_emit = ip
    if ip_end - ip >= INPUT_MARGIN_BYTES:
        ip_limit = ip_end - INPUT_MARGIN_BYTES
        ip += 1
        next_hash = _hash(_load32(inp, ip), shift)
        while True:
            # -- scan for a 4-byte match, skipping faster the longer we miss
            skip = 32
            next_ip = ip
            while True:
                ip = next_ip
                cur_hash = next_hash
                bytes_between = skip >> 5
                skip += bytes_between
                next_ip = ip + bytes_between
                if next_ip > ip_limit:
                    break  # near the end: emit the remainder as a literal
                next_hash = _hash(_load32(inp, next_ip), shift)
                candidate = base_ip + int(table[cur_hash])
                table[cur_hash] = ip - base_ip
                if _load32(inp, candidate) == _load32(inp, ip):
                    break
            if next_ip > ip_limit:
                break
            # -- literal for the unmatched gap, then copies while they chain
            _emit_literal(out, inp, next_emit, ip - next_emit)
            while True:
                matched = 4 + _find_match_length(inp, candidate + 4, ip + 4, ip_end)
                _emit_copy(out, ip - candidate, matched)
                ip += matched
                next_emit = ip
                if ip >= ip_limit:
                    break
                # Seed the table at ip-1 as well, then probe at ip for a
                # back-to-back copy (reference src/internal.jl:224-238).
                table[_hash(_load32(inp, ip - 1), shift)] = ip - 1 - base_ip
                cur = _load32(inp, ip)
                cur_hash = _hash(cur, shift)
                candidate = base_ip + int(table[cur_hash])
                table[cur_hash] = ip - base_ip
                if cur != _load32(inp, candidate):
                    break
            if ip >= ip_limit:
                break
            ip += 1
            next_hash = _hash(_load32(inp, ip), shift)
    # Trailing bytes become one safe-path literal (reference src/internal.jl:242-248).
    if next_emit < ip_end:
        _emit_literal(out, inp, next_emit, ip_end - next_emit)


def compress(data) -> bytes:
    """Compress ``data`` to a raw Snappy stream (varint header + tags).

    Block-independent: the hash table resets every 64 KiB so copy offsets
    never cross block boundaries (reference src/Snappy.jl:20-36)."""
    inp = _as_bytes(data)
    n = len(inp)
    if n > _U32:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    out = bytearray(varint.encode32(n))
    table = np.zeros(hash_table_size(n), dtype=np.int32)
    shift = 32 - int(np.log2(len(table)))
    for block_start in range(0, n, BLOCK_SIZE):
        table[:] = 0
        _compress_block(inp, block_start, min(block_start + BLOCK_SIZE, n), table, shift, out)
    return bytes(out)


def uncompressed_length(comp) -> tuple[int, int]:
    """Parse the varint header: (uncompressed_length, tag_stream_offset)."""
    return varint.parse32(_as_bytes(comp), 0)


def uncompress(comp) -> bytes:
    """Decode a raw Snappy stream, enforcing the reference's corruption checks
    (offset==0, out-of-range offsets/lengths, header/output length mismatch —
    reference src/internal.jl:411-527, src/Snappy.jl:46-52)."""
    inp = _as_bytes(comp)
    clen = len(inp)
    ulen, ip = uncompressed_length(inp)
    out = np.zeros(ulen, dtype=np.uint8)
    op = 0
    # Pad so the blind 4-byte trailer load never runs off the end
    # (reference src/internal.jl:421-430).
    padded = np.concatenate([inp, np.zeros(4, dtype=np.uint8)])
    char_table = CHAR_TABLE
    # A tag at the very last byte can never complete, so the reference's tag
    # loop runs while at least 2 input bytes remain (reference src/internal.jl:416).
    while ip < clen - 1:
        c = int(inp[ip])
        ip += 1
        entry = int(char_table[c])
        taglen = entry >> 11
        trailer = _load32(padded, ip) & int(WORDMASK[taglen])
        length = entry & 0xFF
        ip += taglen
        if c & 0x03 != LITERAL:
            offset = (entry & 0x700) + trailer
            if offset == 0 or op < offset:
                raise CorruptInputError("corrupt copy offset")
            if ulen - op < length:
                raise CorruptInputError("corrupt copy length")
            src = op - offset
            if offset >= length:
                out[op : op + length] = out[src : src + length]
            else:
                # Overlapping copy == run-length expansion: replicate the
                # available window (reference src/internal.jl:469-481).
                reps = -(-length // offset)  # ceil
                out[op : op + length] = np.tile(out[src:op], reps)[:length]
            op += length
        else:
            lit = length + trailer
            if clen - ip < lit or ulen - op < lit:
                raise CorruptInputError("corrupt literal")
            out[op : op + lit] = inp[ip : ip + lit]
            ip += lit
            op += lit
    if op != ulen:
        raise CorruptInputError("uncompressed length mismatch")
    return out.tobytes()
