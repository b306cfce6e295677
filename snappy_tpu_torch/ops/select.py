"""Block decoder selection by device.

The counterpart of ``snappy_tpu/ops/select.py::block_decoder``. The choice
follows the device the caller names, never a probe of the platform: a CUDA
device gets the hand-written kernel, the CPU the plain version. There is no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import cuda_decode, decode_torch


def block_decoder(device):
    """(comp u8[B, C], clens i32[B], ulens i32[B], out_size) ->
    (out u8[B, out_size], ok bool[B], total i32[B]) for ``device``."""
    kind = torch.device(device).type
    if kind == "cuda":
        return cuda_decode.decode_blocks
    if kind == "cpu":
        return decode_torch.decode_blocks
    raise ValueError(f"no block decoder for device {device!r}")
