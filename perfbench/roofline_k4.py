"""K4's bytes: the segmenter of raw streams reads each stream once with
its arguments (a start, a length, a stated size and an output offset: 24
bytes a stream) and writes its segment table (an input offset, an output
offset, a length, an output length and a stream: 28 bytes a segment) and a
flag a stream. Its share of the card's peak is ``roofline.share``'s.

Every stream byte is counted, as K4 reads them all (it builds its step
tables from each byte). A walk of the tags alone would skip the literals'
payload, so the share of that least read is lower by the share of the
stream bytes that are tags (``chip_smoke.py`` phase 17 gives both bounds
on a row group)."""

from __future__ import annotations

from perfbench.roofline import share

__all__ = ["segment_bytes", "share"]

STREAM_ARGS = 8 + 4 + 4 + 8
SEGMENT_ROW = 8 + 8 + 4 + 4 + 4


def segment_bytes(comp_bytes: int, streams: int, segments: int) -> int:
    """Bytes a segmentation of ``streams`` streams of ``comp_bytes`` bytes
    into ``segments`` segments moves at least."""
    return comp_bytes + STREAM_ARGS * streams + SEGMENT_ROW * segments + streams
