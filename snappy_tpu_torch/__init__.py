"""snappy_tpu_torch: the Snappy codec of snappy_tpu, ported to PyTorch and CUDA.

The read path runs on an NVIDIA Hopper GPU: every block of a framed or raw
stream is decoded by a hand-written CUDA kernel (``csrc/decode_blocks.cu``),
with a plain torch version of the same function for CPU tensors. Encoding
uses the native C++ codec on the host.

Public API:
  - compress(data) -> bytes                       raw snappy stream (native)
  - uncompress(data, backend=, device=) -> bytes  decode a raw stream
  - uncompress_framed(frame, device=) -> bytes    decode a framed stream
  - max_compressed_length(n) -> int
  - uncompressed_length(data) -> (n, header_len)

This package imports torch and never jax.
"""

from .api import compress, uncompress, uncompressed_length
from .core import (
    CodecConfig,
    CorruptInputError,
    FrameConfig,
    InputTooLargeError,
    SnappyError,
    max_compressed_length,
)
from .parallel import uncompress_framed

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "CorruptInputError",
    "FrameConfig",
    "InputTooLargeError",
    "SnappyError",
    "compress",
    "max_compressed_length",
    "uncompress",
    "uncompress_framed",
    "uncompressed_length",
]
