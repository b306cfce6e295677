"""K3 on the card: the wrapper of ``csrc/decode_blocks_r4.cu``.

The counterpart of ``snappy_tpu/ops/pallas_decode_r4.py``, the pinned
round-4 decoder, with its contract: ``decode_blocks(comp, clens, ulens,
out_size)`` decodes B headerless tag streams, ``comp`` uint8[B, C]
(C >= clen + COMP_PAD), ``clens`` and ``ulens`` int32[B], into (out
uint8[B, out_size], ok bool[B], total int32[B]), within K3's envelope
(rules in ``ops/decode_torch.py``). Like the reference, it is reached only
by the decode A/B of ``chip_smoke.py``, never through ``ops/select.py``.

A CUDA tensor launches the kernel on the current stream and returns
without synchronising, or raises. Its lengths are not read on the host: a
row with ``ulens`` outside [0, out_size] or ``clens`` outside [0, C - COMP_PAD]
comes back not ok, all zero. A CPU tensor with such a row raises; otherwise
it goes to the plain version, ``decode_torch.decode_blocks_r4``. No other
device is taken.

The kernel walks each stream by one warp into chunks of records while the
block's other warps drain the chunk before; the output row is staged in
shared memory where two blocks still fit an SM (``occupancy`` gives the
size and the blocks an SM for a row width). The design and what bounds it
are in the source's header.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import count
from . import cuda_decode, decode_torch, kernels


def decode_blocks(comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int):
    """Decode B headerless tag streams; see the module docstring. A CUDA
    launch counts under ``k3.launches``."""
    cuda_decode.check_args(comp, clens, ulens, out_size)
    if comp.device.type == "cpu":
        return decode_torch.decode_blocks_r4(comp, clens, ulens, out_size)
    if comp.device.type != "cuda":
        raise ValueError(f"no block decoder for device {comp.device}")
    res = cuda_decode.launch("decode_blocks_r4", "snappy_cuda_decode_blocks_r4", comp, clens, ulens, out_size)
    if comp.shape[0]:
        count("k3.launches")
    return res


def occupancy(out_size: int) -> tuple[int, int]:
    """(bytes of shared memory a block takes for rows of ``out_size`` bytes,
    blocks of it one SM of the current card holds at once). Needs a CUDA
    card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = kernels.load("decode_blocks_r4").snappy_cuda_decode_blocks_r4_occupancy(
        out_size, ctypes.byref(smem), ctypes.byref(blocks)
    )
    kernels.check(rc, "decode_blocks_r4 occupancy")
    return smem.value, blocks.value
