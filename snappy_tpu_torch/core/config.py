"""Runtime configuration.

The same fields and defaults as ``snappy_tpu.core.config``, so that a frame
written under one package's ``FrameConfig`` reads under the other's.
``min_profit`` sets the encode kernel's take threshold; the default
config's ``max_match_scan`` caps the array encoder's match extension
(``ops/encode_array.py``), as in the reference.
"""

from __future__ import annotations

import dataclasses

from .constants import BLOCK_SIZE, INPUT_MARGIN_BYTES, MAX_HASH_TABLE_SIZE


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the codec. Defaults mirror the reference/libsnappy."""

    # Uncompressed bytes per independently-compressed block. Must be
    # <= 65536: offsets are 16-bit.
    block_size: int = BLOCK_SIZE
    # Largest LZ hash table.
    max_hash_table_size: int = MAX_HASH_TABLE_SIZE
    # Fast-path overread margin.
    input_margin: int = INPUT_MARGIN_BYTES
    # Cap on vectorized match extension in the block encoder.
    max_match_scan: int = 512
    # Greedy take threshold for the block encoder: a match is emitted only
    # if it saves at least this many bytes over staying literal.
    min_profit: int = 2

    def __post_init__(self) -> None:
        if not 1 <= self.block_size <= 1 << 16:
            raise ValueError("block_size must be in [1, 65536]")


DEFAULT_CONFIG = CodecConfig()
DEFAULT_MIN_PROFIT = DEFAULT_CONFIG.min_profit


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Options for the framed container (see parallel/framed.py).

    The framed container records per-block compressed sizes and checksums
    so that decode is embarrassingly parallel and resumable.
    """

    block_size: int = BLOCK_SIZE
    checksum: bool = True
    # Greedy take threshold for the block encoder on this frame's blocks.
    min_profit: int = DEFAULT_MIN_PROFIT


DEFAULT_FRAME_CONFIG = FrameConfig()
