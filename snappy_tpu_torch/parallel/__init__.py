"""Framed container and its block-parallel host driver."""

from .framed import FrameIndex, frame_to_raw, parse_index
from .host import uncompress_framed

__all__ = ["FrameIndex", "frame_to_raw", "parse_index", "uncompress_framed"]
