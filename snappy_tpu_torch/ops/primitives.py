"""Tensor building blocks of the plain block decoder (ops/decode_torch.py).

The tag-decode LUTs as tensors, a little-endian 4-byte load at every byte
position, and two small helpers. Plain torch on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import CHAR_TABLE, WORDMASK

# int64 copies of the LUTs: torch's uint32 supports few ops, and gather
# indices must be int64 anyway. Callers move them to their device.
CHAR_TABLE_I64 = torch.from_numpy(CHAR_TABLE.astype(np.int64))
WORDMASK_I64 = torch.from_numpy(WORDMASK.astype(np.int64))


def ceil_log2(n: int) -> int:
    """Static ceil(log2(n)) for n >= 1 (at least 1)."""
    return max(1, int(n - 1).bit_length())


def le32_at_every_position(padded_u8: torch.Tensor) -> torch.Tensor:
    """Little-endian 4-byte value at every byte position, as int64.

    ``padded_u8`` (uint8, [..., n]) must carry >= 4 bytes of slack past the
    last meaningful position. Returns [..., n - 3] with
    ``result[i] = LE32(padded[i:i+4])``.
    """
    n = padded_u8.shape[-1]
    x = padded_u8.to(torch.int64)
    out = x[..., 0 : n - 3].clone()
    for k in range(1, 4):
        out |= x[..., k : n - 3 + k] << (8 * k)
    return out


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x
