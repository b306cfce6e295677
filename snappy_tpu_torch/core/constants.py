"""Snappy wire-format constants, derived from the format specification.

The Snappy raw format (https://github.com/google/snappy/blob/main/format_description.txt)
is fully determined by a handful of constants and one 256-entry tag-decode LUT.
The reference implementation hardcodes the LUT (reference src/internal.jl:47-80);
here we *derive* it from the tag semantics so the bit layout is documented by
construction and trivially auditable.

Tag byte layout (low 2 bits select the element type):
  - LITERAL  (0b00): length-1 in bits 2..7 if < 60, else 59+count of extra
    little-endian length bytes (1..4) that hold length-1.
  - COPY_1   (0b01): length-4 in bits 2..4 (len 4..11); offset bits 8..10 in
    tag bits 5..7, low 8 offset bits in the next byte (offset < 2048).
  - COPY_2   (0b10): length-1 in bits 2..7 (len 1..64); 16-bit LE offset next.
  - COPY_4   (0b11): length-1 in bits 2..7; 32-bit LE offset next
    (decode-only: encoders targeting <64KB blocks never need it,
     reference src/internal.jl:24-31).

LUT entry layout (reference src/internal.jl:36-46):
  bits 0..7   literal/copy length encoded in the opcode byte
  bits 8..10  copy offset high bits, pre-shifted <<8
  bits 11..13 number of extra tag bytes after the opcode (0/1/2/4)
"""

from __future__ import annotations

import numpy as np

# Tag element types (low two bits of the tag byte).
LITERAL = 0x00
COPY_1_BYTE_OFFSET = 0x01
COPY_2_BYTE_OFFSET = 0x02
COPY_4_BYTE_OFFSET = 0x03

# Compression is performed on independent 64 KiB blocks: the hash table holds
# 16-bit in-block offsets and the copy emitter assumes offset <= 65535
# (reference src/internal.jl:22-33). Decoders must NOT assume the absence of
# longer back-references (older encoders used larger blocks).
BLOCK_SIZE = 1 << 16
# The compressor's fast emit paths may overread up to 15 bytes past the
# current position, so matching stops this many bytes before the block end
# (reference src/internal.jl:32).
INPUT_MARGIN_BYTES = 15
MAX_HASH_TABLE_SIZE = 1 << 14

# Multiplicative hash over the 4 bytes at the probe position
# (reference src/internal.jl:94). Any hash yields a valid stream; this one is
# what libsnappy uses, kept so density matches the baseline.
HASH_MULTIPLIER = 0x1E35A7BD

# Maximum length in bytes of a varint32 (reference src/varint.jl:3).
MAX_VARINT32_BYTES = 5

# A literal of 60 bytes costs tag+extra byte -> 62/60 blowup; a 1-byte literal
# followed by a worst-case copy turns 6 input bytes into 7 output bytes. The
# resulting bound (reference src/Snappy.jl:55-82):
def max_compressed_length(n: int) -> int:
    """Upper bound on compressed size for ``n`` input bytes (header included)."""
    return 32 + n + n // 6


def _build_char_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for c in range(256):
        kind = c & 0x03
        hi6 = c >> 2
        if kind == LITERAL:
            if hi6 < 60:
                entry = hi6 + 1  # literal length, no extra tag bytes
            else:
                # hi6 = 59 + count: `count` extra LE bytes hold length-1, and
                # the len field contributes the +1 so len + trailer == length.
                extra = hi6 - 59
                entry = 1 | (extra << 11)
        elif kind == COPY_1_BYTE_OFFSET:
            length = 4 + (hi6 & 0x07)
            offset_hi = (c >> 5) & 0x07
            entry = length | (offset_hi << 8) | (1 << 11)
        elif kind == COPY_2_BYTE_OFFSET:
            entry = (hi6 + 1) | (2 << 11)
        else:  # COPY_4_BYTE_OFFSET
            entry = (hi6 + 1) | (4 << 11)
        table[c] = entry
    return table


# 256-entry decode LUT; behaviour-identical to reference src/internal.jl:47-80.
CHAR_TABLE: np.ndarray = _build_char_table()
CHAR_TABLE.setflags(write=False)

# WORDMASK[i] extracts the low 8*i bits of the blindly-loaded 4-byte trailer
# (reference src/internal.jl:83-85).
WORDMASK: np.ndarray = np.array(
    [0x00000000, 0x000000FF, 0x0000FFFF, 0x00FFFFFF, 0xFFFFFFFF], dtype=np.uint32
)
WORDMASK.setflags(write=False)


def hash_table_size(n: int) -> int:
    """Smallest power of two >= min(n, MAX_HASH_TABLE_SIZE), floor 256.

    Smaller inputs get smaller tables since the O(table) reset would dominate
    (reference src/internal.jl:102-113).
    """
    size = 256
    while size < MAX_HASH_TABLE_SIZE and size < n:
        size <<= 1
    return size
