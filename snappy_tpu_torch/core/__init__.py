"""Format layer: constants, LUTs, varint framing, config, errors."""

from .config import CodecConfig, DEFAULT_CONFIG, DEFAULT_FRAME_CONFIG, FrameConfig
from .constants import (
    BLOCK_SIZE,
    CHAR_TABLE,
    COPY_1_BYTE_OFFSET,
    COPY_2_BYTE_OFFSET,
    COPY_4_BYTE_OFFSET,
    HASH_MULTIPLIER,
    INPUT_MARGIN_BYTES,
    LITERAL,
    MAX_HASH_TABLE_SIZE,
    MAX_VARINT32_BYTES,
    WORDMASK,
    hash_table_size,
    max_compressed_length,
)
from .errors import CorruptInputError, InputTooLargeError, SnappyError
from .varint import encode32, encoded_length, parse32

__all__ = [
    "BLOCK_SIZE",
    "CHAR_TABLE",
    "COPY_1_BYTE_OFFSET",
    "COPY_2_BYTE_OFFSET",
    "COPY_4_BYTE_OFFSET",
    "CodecConfig",
    "CorruptInputError",
    "DEFAULT_CONFIG",
    "DEFAULT_FRAME_CONFIG",
    "FrameConfig",
    "HASH_MULTIPLIER",
    "INPUT_MARGIN_BYTES",
    "InputTooLargeError",
    "LITERAL",
    "MAX_HASH_TABLE_SIZE",
    "MAX_VARINT32_BYTES",
    "SnappyError",
    "WORDMASK",
    "encode32",
    "encoded_length",
    "hash_table_size",
    "max_compressed_length",
    "parse32",
]
