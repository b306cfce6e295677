"""Framed container, its block-parallel host driver, and the mesh and
multi-host drivers."""

from .distributed import AXIS, initialize_multihost, mesh_1d
from .framed import FrameIndex, frame_to_raw, parse_index, raw_to_frame
from .host import compress_framed, uncompress_framed

__all__ = [
    "AXIS",
    "FrameIndex",
    "compress_framed",
    "frame_to_raw",
    "initialize_multihost",
    "mesh_1d",
    "parse_index",
    "raw_to_frame",
    "uncompress_framed",
]
