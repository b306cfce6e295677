"""Block decoder on the card: the wrapper of ``csrc/decode_blocks.cu``.

The counterpart of ``snappy_tpu/ops/pallas_decode.py``, with the same
contract: ``decode_blocks(comp, clens, ulens, out_size)`` decodes B
headerless tag streams, ``comp`` uint8[B, C] (C >= clen + COMP_PAD),
``clens`` and ``ulens`` int32[B], into (out uint8[B, out_size], ok bool[B],
total int32[B]). Rules in ``ops/decode_torch.py``.

A CUDA tensor launches the kernel on the current stream and returns
without synchronising, or raises. Its lengths are not read on the host: a
row with ``ulens`` outside [0, out_size] or ``clens`` outside [0, C - COMP_PAD]
comes back not ok, all zero. A CPU tensor with such a row raises; otherwise
it goes to the plain version, ``decode_torch.decode_blocks``. No other
device is taken.

``decode_segments`` runs the kernel's ragged variant on the rows that K4
(``cuda_segment.segment_streams``) cuts from raw streams lying in one
buffer: row b reads ``clens[b]`` bytes at ``comp[in_starts[b]:]`` and
writes exactly ``ulens[b]`` bytes at ``out[out_starts[b]:]``, with the
rules and ``ok`` and ``total`` of a fixed row; a row that does not decode
zeroes its own bytes and clears its stream's flag in ``stream_ok``.

The kernel runs one warp a row and walks it 32 tags at a time (a chase of
their positions, then each lane reads one tag, then the moves in order):
the compressed row passes through a ring in shared memory and the output
through a window of its last bytes there, flushed to the row with 16-byte
stores, so its shared memory does not
depend on the row's width and one launch takes rows of any width
(``occupancy`` gives its size and the blocks an SM holds). The design and
what bounds it are in the source's header.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..utils.profiling import count, trace_annotation
from . import decode_torch, kernels
from .decode_torch import COMP_PAD


def check_args(comp, clens, ulens, out_size: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2:
        raise TypeError(f"comp must be uint8[B, C], got {comp.dtype}{list(comp.shape)}")
    b, c = comp.shape
    for name, t in (("clens", clens), ("ulens", ulens)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be int32[{b}], got {t.dtype}{list(t.shape)}")
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not comp.is_contiguous():
        raise ValueError("comp must be contiguous")
    if c <= COMP_PAD:
        raise ValueError(f"comp rows must be wider than COMP_PAD={COMP_PAD}")
    if out_size < 1:
        raise ValueError("out_size must be >= 1")
    # Reading the lengths of a CUDA tensor would wait for the stream; there
    # the kernel checks them itself and marks such a row not ok.
    if comp.device.type == "cpu" and b and bool(
        ((ulens < 0) | (ulens > out_size) | (clens < 0) | (clens > c - COMP_PAD)).any()
    ):
        raise ValueError(f"need 0 <= ulens <= out_size={out_size} and 0 <= clens <= C-{COMP_PAD}")


def launch(stem: str, entry: str, comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int,
           span: str | None = None):
    """Allocate (out, ok, total) on comp's CUDA device and launch the block
    decoder ``entry`` of the kernel source ``stem`` on them (checked
    arguments; no launch for zero rows), the launch itself in the span
    ``span`` where one is named."""
    b, c = comp.shape
    out = torch.empty((b, out_size), dtype=torch.uint8, device=comp.device)
    ok = torch.empty(b, dtype=torch.bool, device=comp.device)
    total = torch.empty(b, dtype=torch.int32, device=comp.device)
    if b == 0:
        return out, ok, total
    fn = getattr(kernels.load(stem), entry)
    with torch.cuda.device(comp.device), trace_annotation(span) if span else contextlib.nullcontext():
        rc = fn(
            comp.data_ptr(), clens.data_ptr(), ulens.data_ptr(), b, c, out_size,
            out.data_ptr(), ok.data_ptr(), total.data_ptr(),
            torch.cuda.current_stream(comp.device).cuda_stream,
        )
    kernels.check(rc, f"{entry} launch")
    return out, ok, total


def decode_blocks(comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int):
    """Decode B headerless tag streams; see the module docstring. A CUDA
    launch counts under ``k1.launches``."""
    with trace_annotation("k1.decode_blocks"):
        check_args(comp, clens, ulens, out_size)
        if comp.device.type == "cpu":
            return decode_torch.decode_blocks(comp, clens, ulens, out_size)
        if comp.device.type != "cuda":
            raise ValueError(f"no block decoder for device {comp.device}")
        res = launch("decode_blocks", "snappy_cuda_decode_blocks", comp, clens, ulens, out_size, "k1.launch")
        if comp.shape[0]:
            count("k1.launches")
        return res


def occupancy() -> tuple[int, int]:
    """(bytes of shared memory a block of the kernel takes, blocks of it one
    SM of the current card holds at once). Needs a CUDA card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = kernels.load("decode_blocks").snappy_cuda_decode_blocks_occupancy(ctypes.byref(smem), ctypes.byref(blocks))
    kernels.check(rc, "decode_blocks occupancy")
    return smem.value, blocks.value


def decode_segments(comp: torch.Tensor, rows, nrows: torch.Tensor, out: torch.Tensor, stream_ok: torch.Tensor):
    """Decode K4's rows of the raw streams in ``comp`` (uint8[N]) into
    ``out`` (uint8[M]) in place; see the module docstring. ``rows`` is K4's
    table (in_starts int64, out_starts int64, clens int32, ulens int32,
    streams int32; [R]) and ``nrows`` int64[1] the rows it holds (R at
    most), read on the device: the launch takes R blocks and those past
    ``nrows`` exit. Returns (ok bool[R], total int32[R]), unspecified past
    ``nrows``. Runs in the span ``k1.decode_blocks``; a CUDA launch counts
    under ``k1.launches``."""
    with trace_annotation("k1.decode_blocks"):
        in_starts, out_starts, clens, ulens, streams = rows
        r = in_starts.shape[0]
        for t in (comp, out, stream_ok, nrows, *rows):
            if t.device != comp.device or not t.is_contiguous():
                raise ValueError("the ragged rows, their buffers and flags must be contiguous on one device")
        if comp.dtype != torch.uint8 or out.dtype != torch.uint8 or comp.dim() != 1 or out.dim() != 1:
            raise TypeError("comp and out must be uint8[N]")
        if comp.device.type == "cpu":
            return decode_segments_plain(comp, rows, int(nrows[0]), out, stream_ok)
        if comp.device.type != "cuda":
            raise ValueError(f"no block decoder for device {comp.device}")
        ok = torch.empty(r, dtype=torch.bool, device=comp.device)
        total = torch.empty(r, dtype=torch.int32, device=comp.device)
        if r == 0:
            return ok, total
        fn = kernels.load("decode_blocks").snappy_cuda_decode_segments
        with torch.cuda.device(comp.device), trace_annotation("k1.launch"):
            rc = fn(comp.data_ptr(), comp.numel(), in_starts.data_ptr(), clens.data_ptr(), out_starts.data_ptr(),
                    ulens.data_ptr(), streams.data_ptr(), nrows.data_ptr(), r, out.data_ptr(), out.numel(),
                    ok.data_ptr(), total.data_ptr(), stream_ok.data_ptr(),
                    torch.cuda.current_stream(comp.device).cuda_stream)
        kernels.check(rc, "snappy_cuda_decode_segments launch")
        count("k1.launches")
        return ok, total


def decode_segments_plain(comp: torch.Tensor, rows, nrows: int, out: torch.Tensor, stream_ok: torch.Tensor):
    """The ragged rows through the plain version on CPU tensors: the first
    ``nrows`` rows that fit their buffers are gathered into zero-padded
    fixed rows, decoded by ``decode_torch.decode_blocks``, and each row's
    first ``ulens`` bytes (zeros where it is not ok) put at its place."""
    in_starts, out_starts, clens, ulens, streams = (t[:nrows].long() for t in rows)
    r = rows[0].shape[0]
    ok = torch.zeros(r, dtype=torch.bool)
    total = torch.zeros(r, dtype=torch.int32)
    fits = ((in_starts >= 0) & (clens >= 0) & (in_starts <= comp.numel() - clens) & (out_starts >= 0) & (ulens >= 0)
            & (out_starts <= out.numel() - ulens))
    idx = fits.nonzero()[:, 0]
    if len(idx):
        cl, ul = clens[idx], ulens[idx]
        width = -(-(int(cl.max()) + COMP_PAD) // 16) * 16
        col = torch.arange(width)
        src = in_starts[idx][:, None] + col
        batch = torch.where(col < cl[:, None], comp[src.clamp(max=max(comp.numel() - 1, 0))], 0).to(torch.uint8)
        o, k, tot = decode_torch.decode_blocks(batch, cl.int(), ul.int(), max(int(ul.max()), 1))
        ok[idx], total[idx] = k, tot
        ocol = torch.arange(o.shape[1])
        keep = ocol < ul[:, None]
        dst = (out_starts[idx][:, None] + ocol)[keep]
        out[dst] = o[keep]
    bad = streams[~ok[:nrows]]
    stream_ok[bad] = 0
    return ok, total
