"""K5's bytes: the join of raw streams reads each fragment's stream once
with its length (4 bytes a fragment) and writes the packed streams, a start
and a length a stream (8 + 4 bytes), once. The fragments' streams are the
packed streams less their headers, at most 5 bytes a stream, so the read is
counted as the packed bytes less 5 a stream: the least it can be. Its share
of the card's peak is ``roofline.share``'s."""

from __future__ import annotations

from perfbench.roofline import share

__all__ = ["join_bytes", "share"]

FRAGMENT_LEN = 4
STREAM_OUT = 8 + 4
MAX_HEADER = 5


def join_bytes(comp_bytes: int, streams: int, fragments: int) -> int:
    """Bytes a join of ``fragments`` fragment streams into ``streams``
    streams of ``comp_bytes`` bytes, headers included, moves at least."""
    return max(comp_bytes - MAX_HEADER * streams, 0) + FRAGMENT_LEN * fragments + comp_bytes + STREAM_OUT * streams
