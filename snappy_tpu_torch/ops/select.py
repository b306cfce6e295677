"""Block codec selection by device.

The counterpart of ``snappy_tpu/ops/select.py``. The choice follows the
device the caller names, never a probe of the platform, and is made in one
place: each kernel's wrapper launches its kernel for a CUDA tensor and runs
its plain version for a CPU tensor, with no fallback from one to the
other. Here a device that neither takes is refused before any data moves.
"""

from __future__ import annotations

import torch

from . import cuda_decode, cuda_encode


def _check_device(device, what: str) -> None:
    if torch.device(device).type not in ("cuda", "cpu"):
        raise ValueError(f"no block {what} for device {device!r}")


def block_decoder(device):
    """(comp u8[B, C], clens i32[B], ulens i32[B], out_size) ->
    (out u8[B, out_size], ok bool[B], total i32[B]) for ``device``."""
    _check_device(device, "decoder")
    return cuda_decode.decode_blocks


def block_encoder(device):
    """(blocks u8[B, W], blens i32[B], min_profit) ->
    (out u8[B, BLOCK_MAX_OUT], olens i32[B]) for ``device``. Any block size
    in [1, 65536] is taken."""
    _check_device(device, "encoder")
    return cuda_encode.encode_blocks
