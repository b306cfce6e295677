"""Framed container and its block-parallel host driver."""

from .framed import FrameIndex, frame_to_raw, parse_index, raw_to_frame
from .host import compress_framed, uncompress_framed

__all__ = ["FrameIndex", "compress_framed", "frame_to_raw", "parse_index", "raw_to_frame", "uncompress_framed"]
