"""Tensor building blocks of the plain block decoder (ops/decode_torch.py)
and the array encoder (ops/encode_array.py).

The tag-decode LUTs as tensors, a little-endian 4-byte load at every byte
position, the pointer-doubling orbit ``reach_from`` and two small helpers.
Plain torch on any device.
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


def reach_from(start, nxt: torch.Tensor, n: int, rounds: int | None = None) -> torch.Tensor:
    """Positions reachable from ``start`` by iterating i -> nxt[i], per row.

    The counterpart of ``snappy_tpu/ops/primitives.py::reach_from``, batched
    over the leading dimensions of ``nxt`` ([..., n]). ``nxt`` must be
    strictly increasing (nxt[i] > i) with values in [0, n], where n is the
    absorbing sentinel; ``start`` is an int or a tensor of the leading
    shape. Returns bool[..., n].

    Pointer doubling: after round k, ``reach`` holds every chain position at
    distance < 2**k and ``jump`` is the 2**k-step map, so ceil(log2(n + 1))
    rounds cover any chain. Each round's scatter reads the ``reach`` of
    the round before (``scatter_reduce`` into a copy, as ``.at[].max``).
    """
    if rounds is None:
        rounds = ceil_log2(n + 1)
    dev = nxt.device
    sentinel = torch.full((*nxt.shape[:-1], 1), n, dtype=torch.int64, device=dev)
    jump = torch.cat([nxt.to(torch.int64), sentinel], dim=-1)
    start = torch.as_tensor(start, dtype=torch.int64, device=dev).unsqueeze(-1)
    reach = (torch.arange(n + 1, device=dev) == start).to(torch.int32).expand_as(jump).contiguous()
    for _ in range(rounds):
        reach = reach.scatter_reduce(-1, jump, reach, "amax")
        jump = jump.gather(-1, jump)
    return reach[..., :n] > 0
