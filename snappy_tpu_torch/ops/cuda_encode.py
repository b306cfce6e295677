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

``encode_fragments(data, fstarts, flens, min_profit, max_block)`` is the
ragged entry: row r is the ``flens[r]`` bytes at ``fstarts[r]`` of the
uint8 buffer ``data``, read in place by the kernel (the same
``encode_blocks_kernel``), which stages it as it stages a fixed row, so the
same bytes give the same stream. ``max_block`` picks the variant as a row
of ``max_block + ENC_PAD`` bytes does; a fragment longer than it, or that
does not lie in ``data``, comes back with ``olens = -1`` and all zero on a
card, and raises on the CPU, whose plain version gathers the fragments
into fixed rows for ``encode_torch.encode_blocks``.
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


def encode_fragments(data: torch.Tensor, fstarts: torch.Tensor, flens: torch.Tensor, min_profit: int,
                     max_block: int, out: torch.Tensor, olens: torch.Tensor):
    """Encode the R fragments of ``data`` (uint8[N]) that ``fstarts``
    (int64[R]) and ``flens`` (int32[R]) give into headerless tag streams, in
    ``out`` (uint8[R, BLOCK_MAX_OUT]) and ``olens`` (int32[R]), which it
    returns; see the module docstring. Runs in the span
    ``k2.encode_fragments``; a CUDA launch counts under ``k2.launches``,
    ``k2.rows`` and ``k2.sm_rows``."""
    with trace_annotation("k2.encode_fragments"):
        r = _check_fragments(data, fstarts, flens, min_profit, max_block)
        dev = data.device
        if tuple(out.shape) != (r, BLOCK_MAX_OUT) or tuple(olens.shape) != (r,) or not out.is_contiguous():
            raise ValueError(f"out and olens must be uint8[{r}, {BLOCK_MAX_OUT}] and int32[{r}], contiguous")
        if dev.type == "cpu":
            return encode_fragments_plain(data, fstarts, flens, min_profit, max_block, out, olens)
        if dev.type != "cuda" or out.device != dev or olens.device != dev:
            raise ValueError(f"no block encoder for device {dev}")
        if r == 0:
            return out, olens
        lib = kernels.load("encode_blocks")
        with torch.cuda.device(dev), trace_annotation("k2.launch"):
            rc = lib.snappy_cuda_encode_fragments(
                data.data_ptr(), data.numel(), fstarts.data_ptr(), flens.data_ptr(), r, max_block, BLOCK_MAX_OUT,
                min_profit, out.data_ptr(), olens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(rc, "encode_fragments launch")
        count("k2.launches")
        count("k2.rows", r)
        count("k2.sm_rows", r * _blocks_per_sm(dev.index, max_block + ENC_PAD))
        return out, olens


def check_ranges(data, starts, lens, names: tuple[str, str]) -> int:
    """The count of byte ranges ``starts`` (int64[n]), ``lens`` (int32[n])
    of the buffer ``data`` (contiguous uint8[N], their device), or raise on
    arguments of the wrong kind; ``names`` name the two in the message."""
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise TypeError(f"data must be contiguous uint8[N], got {data.dtype}{list(data.shape)}")
    n = starts.shape[0] if starts.dim() == 1 else -1
    for name, t, dtype in zip(names, (starts, lens), (torch.int64, torch.int32)):
        if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dtype}[{n}], got {t.dtype}{list(t.shape)}")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
    return n


def _check_fragments(data, fstarts, flens, min_profit: int, max_block: int) -> int:
    r = check_ranges(data, fstarts, flens, ("fstarts", "flens"))
    if not 1 <= max_block <= MAX_BLOCK:
        raise ValueError(f"max_block must be 1 to {MAX_BLOCK}, got {max_block}")
    if not isinstance(min_profit, int):
        raise TypeError("min_profit must be an int")
    if data.device.type == "cpu" and r:
        starts, lens = fstarts, flens.long()
        if bool(((lens < 0) | (lens > max_block) | (starts < 0) | (starts > data.numel() - lens)).any()):
            raise ValueError(f"every fragment must lie in data and hold 0 to {max_block} bytes")
    return r


def encode_fragments_plain(data, fstarts, flens, min_profit: int, max_block: int, out, olens):
    """The plain version of the ragged entry on CPU tensors: the fragments
    that hold a byte gathered into zero-padded rows of ``max_block +
    ENC_PAD`` bytes and encoded by ``encode_torch.encode_blocks``; empty
    fragments give an empty stream, as the kernel's rows do."""
    out.zero_()
    olens.zero_()
    keep = (flens > 0).nonzero()[:, 0]
    if len(keep):
        lens = flens[keep].long()
        col = torch.arange(max_block + ENC_PAD)
        src = (fstarts[keep][:, None] + col).clamp(max=data.numel() - 1)
        rows = torch.where(col < lens[:, None], data[src], 0).to(torch.uint8)
        o, n = encode_torch.encode_blocks(rows, flens[keep], min_profit)
        out[keep], olens[keep] = o, n
    return out, olens
