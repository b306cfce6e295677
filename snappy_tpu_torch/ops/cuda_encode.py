"""Block encoder on the card: the wrapper of ``csrc/encode_blocks.cu``.

The counterpart of ``snappy_tpu/ops/pallas_encode.py::encode_blocks_jit``
with ``contest=False``, with the same contract:
``encode_blocks(blocks, blens, min_profit)`` encodes B blocks, uint8[B, W]
with blen <= W - ENC_PAD <= 65536 and zero past blen, into
(out uint8[B, BLOCK_MAX_OUT], olens int32[B]); ``out`` is zero past
``olens``. Rules in ``ops/encode_torch.py``.

This wrapper is where the device is chosen, for the encoder as for the
decoder (``ops/cuda_decode.py``): a CUDA tensor launches the kernel on the
current stream and returns without synchronising, or raises. Its lengths
are not read on the host: a row with ``blens`` outside [0, W - ENC_PAD]
comes back with ``olens = -1``, all zero. A CPU tensor with such a row
raises; otherwise it goes to the plain version,
``encode_torch.encode_blocks``. No other device is taken.

The kernel comes in two variants, picked by the launch from the row width:
rows of up to 32 KiB of block take a layout half the size, two blocks an
SM; wider rows one block an SM (``occupancy`` gives a width's shared memory
a block and blocks an SM). A CUDA launch counts its rows under ``k2.rows``
and, each weighted by the blocks an SM of its variant, under
``k2.sm_rows``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count, trace_annotation
from . import encode_torch, kernels
from .encode_torch import BLOCK_MAX_OUT, ENC_PAD

# Largest block the kernel takes: copy offsets are 16 bits.
MAX_BLOCK = 1 << 16


def _check_args(blocks, blens, min_profit: int) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"blocks must be uint8[B, W], got {blocks.dtype}{list(blocks.shape)}")
    b, w = blocks.shape
    if blens.dtype != torch.int32 or tuple(blens.shape) != (b,):
        raise TypeError(f"blens must be int32[{b}], got {blens.dtype}{list(blens.shape)}")
    if blens.device != blocks.device:
        raise ValueError(f"blens is on {blens.device}, blocks on {blocks.device}")
    if not (blocks.is_contiguous() and blens.is_contiguous()):
        raise ValueError("blocks and blens must be contiguous")
    if not ENC_PAD <= w <= MAX_BLOCK + ENC_PAD:
        raise ValueError(f"block rows must be {ENC_PAD} to {MAX_BLOCK + ENC_PAD} bytes wide, got {w}")
    if not isinstance(min_profit, int):
        raise TypeError("min_profit must be an int")
    # Reading the lengths of a CUDA tensor would wait for the stream; there
    # the kernel checks them itself and refuses such a row.
    if blocks.device.type == "cpu" and b and bool(((blens < 0) | (blens > w - ENC_PAD)).any()):
        raise ValueError(f"need 0 <= blens <= W - {ENC_PAD} = {w - ENC_PAD}")


def launch(blocks: torch.Tensor, blens: torch.Tensor, min_profit: int):
    """Allocate (out, olens) on the device of ``blocks`` and launch the
    kernel on them (checked arguments; no launch for zero rows)."""
    b, w = blocks.shape
    out = torch.empty((b, BLOCK_MAX_OUT), dtype=torch.uint8, device=blocks.device)
    olens = torch.empty(b, dtype=torch.int32, device=blocks.device)
    if b == 0:
        return out, olens
    lib = kernels.load("encode_blocks")
    with torch.cuda.device(blocks.device), trace_annotation("k2.launch"):
        rc = lib.snappy_cuda_encode_blocks(
            blocks.data_ptr(), blens.data_ptr(), b, w, BLOCK_MAX_OUT, min_profit,
            out.data_ptr(), olens.data_ptr(),
            torch.cuda.current_stream(blocks.device).cuda_stream,
        )
    kernels.check(rc, "encode_blocks launch")
    return out, olens


def encode_blocks(blocks: torch.Tensor, blens: torch.Tensor, min_profit: int):
    """Encode B blocks into headerless tag streams; see the module
    docstring. A CUDA launch counts under ``k2.launches``, ``k2.rows`` and
    ``k2.sm_rows``."""
    with trace_annotation("k2.encode_blocks"):
        _check_args(blocks, blens, min_profit)
        if blocks.device.type == "cpu":
            return encode_torch.encode_blocks(blocks, blens, min_profit)
        if blocks.device.type != "cuda":
            raise ValueError(f"no block encoder for device {blocks.device}")
        res = launch(blocks, blens, min_profit)
        b, w = blocks.shape
        if b:
            count("k2.launches")
            count("k2.rows", b)
            count("k2.sm_rows", b * _blocks_per_sm(blocks.device.index, w))
        return res


def occupancy(row_w: int) -> tuple[int, int]:
    """(bytes of shared memory a block takes for rows of ``row_w`` bytes,
    blocks of it one SM of the current card holds at once). Needs a CUDA
    card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = kernels.load("encode_blocks").snappy_cuda_encode_blocks_occupancy(
        row_w, ctypes.byref(smem), ctypes.byref(blocks)
    )
    kernels.check(rc, "encode_blocks occupancy")
    return smem.value, blocks.value


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, row_w: int) -> int:
    with torch.cuda.device(index):
        return occupancy(row_w)[1]
