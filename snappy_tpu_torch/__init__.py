"""snappy_tpu_torch: the Snappy codec of snappy_tpu, ported to PyTorch and CUDA.

The read and write paths run on an NVIDIA Hopper GPU: every block of a
framed or raw stream is decoded by a hand-written CUDA kernel
(``csrc/decode_blocks.cu``), and every compressible 64 KiB block is encoded
by another (``csrc/encode_blocks.cu``), while incompressible blocks go to
the native C++ encoder on the host. A third kernel, the pinned round-4
decoder (``csrc/decode_blocks_r4.cu``), is the other side of the decode
A/B in ``chip_smoke.py`` and no entry point selects it. Each kernel has a
plain torch version of the same function for CPU tensors. Framed calls
shard their blocks over a mesh of devices with ``mesh=``, and
``parallel/multihost.py`` writes and reads one frame from several processes.
The write paths take ``encoder="array"`` for the JAX package's off-TPU
parse, ``ops/encode_array.py``, in torch on either device, in place of the
encode kernel (``encoder="kernel"``, the default).

Public API:
  - compress(data, backend=, device=, encoder=) -> bytes  raw snappy stream
                                                  (backends "native",
                                                  "torch", "cpu")
  - uncompress(data, backend=, device=) -> bytes  decode a raw stream
  - compress_framed(data, config=, device=, mesh=, encoder=)  framed stream
  - uncompress_framed(frame, device=, mesh=)      decode a framed stream
  - mesh_1d(devices=None) -> Mesh                 the devices a framed call
                                                  shards its blocks over
                                                  (mesh=; every CUDA device
                                                  by default)
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
from .parallel import compress_framed, mesh_1d, uncompress_framed

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "CorruptInputError",
    "FrameConfig",
    "InputTooLargeError",
    "SnappyError",
    "compress",
    "compress_framed",
    "max_compressed_length",
    "mesh_1d",
    "uncompress",
    "uncompress_framed",
    "uncompressed_length",
]
