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
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import varint
from ..core.config import DEFAULT_MIN_PROFIT
from ..core.constants import BLOCK_SIZE
from ..core.errors import CorruptInputError, InputTooLargeError
from ..native import runtime as nat
from ..utils.profiling import trace_annotation
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


def pack_rows(buf: np.ndarray, starts: np.ndarray, clens: np.ndarray) -> np.ndarray:
    """Copy the ragged byte ranges ``buf[starts[i] : starts[i] + clens[i]]``
    into the rows of a zero-padded uint8[n, C] batch, with C the widest
    range plus COMP_PAD rounded up to 16 bytes."""
    width = -(-(int(clens.max()) + COMP_PAD) // 16) * 16
    rows = np.zeros((len(starts), width), np.uint8)
    for i, (s, n) in enumerate(zip(starts.tolist(), clens.tolist())):
        rows[i, :n] = buf[s : s + n]
    return rows


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


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``. A CUDA copy goes through pinned
    memory and does not wait for work already queued on the stream."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def uncompress(data, device="cuda") -> bytes:
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
            with trace_annotation("snappy.uncompress_windowed"):
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
    comp = pack_rows(body, starts, clens)
    with trace_annotation("snappy.uncompress_blocked"):
        out, ok, _ = block_decoder(device)(
            to_device(comp, device),
            to_device(clens.astype(np.int32), device),
            to_device(oplens.astype(np.int32), device),
            out_size,
        )
        ok = ok.cpu().numpy()
        if not ok.all():
            raise CorruptInputError("corrupt snappy stream")
        out = out.cpu().numpy()
    if (oplens == out_size).all():
        return out.tobytes()
    keep = np.arange(out_size)[None, :] < oplens[:, None]
    return out[keep].tobytes()


def compress(data, device="cuda", encoder: str = "kernel") -> bytes:
    """Compress into a raw Snappy stream, encoding the compressible blocks
    with the block encoder ``encoder`` (``select.ENCODERS``) on ``device``."""
    from . import route  # route builds on to_device above

    check_encoder(encoder)
    inp = as_u8(data)
    n = len(inp)
    if n > 0xFFFFFFFF:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    header = varint.encode32(n)
    if n == 0:
        return header
    with trace_annotation("snappy.compress"):
        buf, blens = blockify(inp, BLOCK_SIZE)
        k = ROUTE_CHUNK_BLOCKS
        host_idx = np.concatenate(
            [c + route.host_blocks(buf[c : c + k], blens[c : c + k]) for c in range(0, len(blens), k)]
        )
        ticket = route.dispatch_routed(buf, blens, host_idx, device, DEFAULT_MIN_PROFIT, encoder)
        return header + b"".join(route.assemble_routed(ticket))
