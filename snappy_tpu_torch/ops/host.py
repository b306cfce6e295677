"""Host driver of raw-stream encode and decode on one device.

``compress`` is the counterpart of ``snappy_tpu/ops/encode_xla.py::
compress_host``: the stream is cut into 64 KiB blocks, routed 16 blocks at
a time as the reference routes them, the device blocks of all chunks are
encoded in one call of the block encoder (K2, the reference's pick on a
TPU, or with ``encoder="array"`` the array encoder, its pick elsewhere)
while the host encodes the routed ones, and the block streams are joined
under the varint header.

``uncompress`` is the counterpart of ``snappy_tpu/ops/host.py:40-133``. The
host parses the varint header, the native ``scan_blocks`` cuts the tag
stream into segments of at most 128 KiB of output at tag boundaries, and
the block decoder runs all segments in one batched launch. A stream that ``scan_blocks`` declines,
or any stream where the native library cannot load, goes to the same
decoder as one headerless block. On a CUDA device that is
the kernel, which has no size limit; on the CPU it is the plain version,
whose memory grows with the stream, so above ``decode_torch.RAW_WHOLE_LIMIT``
compressed bytes such a stream goes to ``decode_torch.decode_raw_windowed``
instead (as ``snappy_tpu/ops/host.py:55-60`` does). Both give the same bytes.

The copies between host and card that every driver shares live here too:
``stage`` sends host arrays in one pinned copy, ``pack_batch`` builds the
decoder's zero-padded rows on the device from the streams as they lie end
to end (no host loop, no zero-filled host batch), and ``HostCopy`` brings
results back behind an event of their own, so that the host waits for one
batch and not for the work queued after it.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from ..core import varint
from ..core.config import DEFAULT_MIN_PROFIT
from ..core.constants import BLOCK_SIZE
from ..core.errors import CorruptInputError, InputTooLargeError
from ..native import runtime as nat
from ..utils.profiling import count, trace_annotation
from . import decode_torch
from .decode_torch import COMP_PAD
from .encode_torch import ENC_PAD
from .select import block_decoder, check_encoder

_I32_MAX = (1 << 31) - 1
# Blocks routed together by the raw encoder, as the reference's
# ``encode_xla.MAX_BATCH_BLOCKS``: a block's routing score depends on the
# batch it is scored in, so the same chunks give the same bytes.
ROUTE_CHUNK_BLOCKS = 16


def as_u8(data) -> np.ndarray:
    """``data`` (bytes-like, str, or a uint8 array) as a contiguous uint8
    array, without a copy where it already is one."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return np.ascontiguousarray(data)
    if isinstance(data, str):
        data = data.encode("utf-8")
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def row_width(clens: np.ndarray) -> int:
    """The decoder's row width for streams of ``clens`` bytes: the widest
    plus COMP_PAD, rounded up to 16 bytes."""
    return -(-(int(clens.max(initial=0)) + COMP_PAD) // 16) * 16


def pack_rows(buf: np.ndarray, starts: np.ndarray, clens: np.ndarray) -> np.ndarray:
    """Copy the ragged byte ranges ``buf[starts[i] : starts[i] + clens[i]]``
    into the rows of a zero-padded uint8[n, row_width(clens)] batch, one row
    at a time: the host tools' batches, and what ``pack_batch`` is held to."""
    rows = np.zeros((len(starts), row_width(clens)), np.uint8)
    for i, (s, n) in enumerate(zip(starts.tolist(), clens.tolist())):
        rows[i, :n] = buf[s : s + n]
    return rows


def rows_from_span(body: torch.Tensor, clens: torch.Tensor, width: int) -> torch.Tensor:
    """The streams that lie end to end in ``body`` (uint8), ``clens[i]``
    bytes each (int32, summing to ``len(body)``), as the rows of a
    zero-padded uint8[len(clens), width] batch, on body's device: one
    scatter, whose indices are computed there without a host sync."""
    lens = clens.long()
    dev = body.device
    # Byte j of stream i sits at span offset starts[i] + j and goes to flat
    # offset i * width + j: its span offset plus its row's shift.
    shift = torch.arange(len(lens), device=dev) * width - (torch.cumsum(lens, 0) - lens)
    dst = torch.arange(len(body), device=dev) + torch.repeat_interleave(shift, lens, output_size=len(body))
    rows = torch.zeros((len(lens), width), dtype=torch.uint8, device=dev)
    rows.view(-1).index_copy_(0, dst, body)
    return rows


def pack_batch(span: np.ndarray, clens: np.ndarray, ulens: np.ndarray, rows: int, device):
    """The block decoder's arguments for the streams that lie end to end in
    the host array ``span``, ``clens[i]`` bytes each, of ``ulens[i]`` output
    bytes, padded with empty rows (clen = ulen = 0) to ``rows``: (comp
    uint8[rows, C], clens int32[rows], ulens int32[rows]) on ``device``,
    with the rows ``pack_rows`` gives. The span and the lengths go over in
    one ``stage``; the rows are built on the device (``rows_from_span``).
    Runs in the span ``host.pack``."""
    n = len(clens)
    if len(span) != int(np.sum(clens, dtype=np.int64)):
        raise ValueError(f"the span holds {len(span)} bytes, the streams {int(np.sum(clens, dtype=np.int64))}")
    with trace_annotation("host.pack"):
        lens = np.zeros((2, rows), np.int32)
        lens[0, :n], lens[1, :n] = clens, ulens
        body, lens = stage([span, lens], device)
        return rows_from_span(body, lens[0], row_width(clens)), lens[0], lens[1]


def blockify(inp: np.ndarray, block_size: int, rows: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The blocks of ``inp`` as the rows of a uint8[rows, block_size + ENC_PAD]
    batch, zero past each block, and their lengths int32[rows]; one copy.
    ``rows`` defaults to the block count; rows past it are empty (blen 0)."""
    n = len(inp)
    n_blocks = -(-n // block_size)
    full = n // block_size
    buf = np.zeros((n_blocks if rows is None else rows, block_size + ENC_PAD), np.uint8)
    buf[:full, :block_size] = inp[: full * block_size].reshape(full, block_size)
    blens = np.zeros(len(buf), np.int32)
    blens[:full] = block_size
    if full < n_blocks:
        buf[full, : n - full * block_size] = inp[full * block_size :]
        blens[full] = n - full * block_size
    return buf, blens


# Host work spread over the cores: the staged copies below and the framed
# container's crcs. The pool starts its threads at its first use.
HOST_THREADS = os.cpu_count() or 1
HOST_POOL = concurrent.futures.ThreadPoolExecutor(HOST_THREADS, thread_name_prefix="snappy-host")
# The least a thread copies: below it a thread's start costs more than it saves.
_COPY_RUN = 1 << 20
# Offsets of the arrays in one staged copy: a row of the kernels' batches
# starts 16-byte aligned on the card as in a tensor of its own.
_STAGE_ALIGN = 256


def copy_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[:] = src`` for two 1-D uint8 arrays of one length, in runs on
    ``HOST_POOL`` (numpy copies without the interpreter lock)."""
    per = max(_COPY_RUN, -(-len(src) // HOST_THREADS))
    if len(src) <= per:
        dst[:] = src
        return
    list(HOST_POOL.map(lambda i: np.copyto(dst[i : i + per], src[i : i + per]), range(0, len(src), per)))


def stage(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """The host arrays ``arrays`` as tensors on ``device``. To a CUDA device
    they go packed into one pinned buffer (``copy_into``), in one copy
    queued on the current stream without waiting for the work already
    there; the buffer comes from PyTorch's caching host allocator, which
    hands it out again once that copy has run, so a stream of batches
    reuses its staging. Runs in the span ``host.stage`` and counts the
    arrays' bytes under ``host.staged_bytes``."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    count("host.staged_bytes", sum(a.nbytes for a in arrays))
    with trace_annotation("host.stage"):
        if torch.device(device).type != "cuda":
            return [torch.from_numpy(a if a.flags.writeable else a.copy()).to(device) for a in arrays]
        offsets, end = [], 0
        for a in arrays:
            offsets.append(end)
            end += -(-a.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
        pinned = torch.empty(end, dtype=torch.uint8, pin_memory=True)
        host = pinned.numpy()
        for a, o in zip(arrays, offsets):
            copy_into(host[o : o + a.nbytes], a.reshape(-1).view(np.uint8))
        whole = pinned.to(device, non_blocking=True)
        dtypes = [torch.from_numpy(np.empty(0, a.dtype)).dtype for a in arrays]
        return [whole[o : o + a.nbytes].view(t).view(a.shape) for a, o, t in zip(arrays, offsets, dtypes)]


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device`` (``stage`` of one array)."""
    return stage([a], device)[0]


class HostCopy:
    """Results of work queued on a device, on their way to the host. On a
    CUDA device each tensor is copied into pinned host memory on the
    device's current stream, behind the work that makes it, and an event is
    recorded after the copies; ``wait`` waits for that event alone, not for
    the work queued after it, and a fault on the card raises there. CPU
    tensors are held as they are. The pinned buffers go back to PyTorch's
    caching host allocator when the last array read from them is dropped."""

    def __init__(self, tensors):
        tensors = list(tensors)
        dev = tensors[0].device
        if any(t.device != dev for t in tensors):
            raise ValueError("a HostCopy's tensors must lie on one device")
        self._event = None
        if dev.type != "cuda":
            self._host = tensors
            return
        with torch.cuda.device(dev):
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> list[np.ndarray]:
        """The results as host arrays, once their own copies have landed;
        the wait for them, on a card, in the span ``host.wait``."""
        if self._event is not None:
            with trace_annotation("host.wait"):
                self._event.synchronize()
        return [h.numpy() for h in self._host]


def uncompress(data, *, device="cuda") -> bytes:
    """Decode a raw Snappy stream on ``device``. Raises CorruptInputError
    on a corrupt stream."""
    comp = as_u8(data)
    ulen, start = varint.parse32(comp, 0)
    body = comp[start:]
    # Without the native library nothing segments the stream, as in the
    # reference (snappy_tpu/ops/host.py:84-85).
    scan = nat.scan_blocks(body, ulen) if nat.available() else None  # raises CorruptInputError
    if scan is None:
        # The scan stopped early, so the header is not yet checked against
        # the body: no tag yields more than 64 bytes from 3 (COPY_2).
        if 3 * ulen > 64 * len(body):
            raise CorruptInputError("header claims more output than the stream can hold")
        if torch.device(device).type == "cpu" and len(body) > decode_torch.RAW_WHOLE_LIMIT:
            return decode_torch.decode_raw_windowed(body, ulen, 0)
        if ulen > _I32_MAX:
            raise NotImplementedError("unsegmentable raw stream over 2 GiB")
        starts, oplens = np.zeros(1, np.int64), np.array([ulen], np.int64)
    else:
        starts, oplens = scan
    if len(starts) == 0:
        return b""
    return _uncompress_blocked(body, starts, oplens.astype(np.int64), device)


def _uncompress_blocked(body: np.ndarray, starts: np.ndarray, oplens: np.ndarray, device) -> bytes:
    """Decode the segments ``body[starts[i]:starts[i+1]]``, of ``oplens[i]``
    output bytes each, in one batched launch, and join them."""
    clens = np.diff(np.append(starts, len(body)))
    out_size = -(-max(int(oplens.max()), 1) // 16) * 16
    batch = pack_batch(body[int(starts[0]) :], clens, oplens, len(starts), device)
    out, ok, _ = HostCopy(block_decoder(device)(*batch, out_size)).wait()
    if not ok.all():
        raise CorruptInputError("corrupt snappy stream")
    if (oplens == out_size).all():
        return out.tobytes()
    keep = np.arange(out_size)[None, :] < oplens[:, None]
    return out[keep].tobytes()


def compress(data, *, device="cuda", encoder: str = "kernel") -> bytes:
    """Compress into a raw Snappy stream, encoding the compressible blocks
    with the block encoder ``encoder`` (``select.ENCODERS``) on ``device``."""
    from . import route  # route builds on stage and HostCopy above

    check_encoder(encoder)
    inp = as_u8(data)
    n = len(inp)
    if n > 0xFFFFFFFF:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    header = varint.encode32(n)
    if n == 0:
        return header
    buf, blens = blockify(inp, BLOCK_SIZE)
    k = ROUTE_CHUNK_BLOCKS
    host_idx = np.concatenate(
        [c + route.host_blocks(buf[c : c + k], blens[c : c + k]) for c in range(0, len(blens), k)]
    )
    ticket = route.dispatch_routed(buf, blens, host_idx, device, DEFAULT_MIN_PROFIT, encoder)
    return header + b"".join(route.assemble_routed(ticket))
