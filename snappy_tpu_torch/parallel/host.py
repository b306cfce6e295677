"""Host driver of framed encode and decode, on one device or over a mesh.

The counterpart of ``snappy_tpu/parallel/host.py``. ``dispatch_compress``
cuts the stream into blocks, routes the incompressible ones to the host
encoder and launches the block encoder on the rest, asynchronously on the
current stream; ``assemble_compress`` waits for it and builds the frame.
``dispatch_uncompress`` packs the frame's blocks into one batch, copies it
to the device and launches the block decoder; ``assemble_uncompress``
waits for it, checks every block's ``ok`` flag and crc, and joins the
blocks. The splits let a pipeline prepare frame k+1 while the device works
on frame k.

With ``mesh=`` (``distributed.mesh_1d``) the batch is padded to a multiple
of the mesh size and sharded over its devices, one launch a shard, and
``device`` is not used. As in the reference, the mesh path routes no
block: every block is encoded on the devices, so a frame with
incompressible blocks may differ from the routed one (both are valid). The
frame is a function of the data and the config alone, never of the mesh.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..ops import route
from ..ops.host import as_u8, blockify, pack_rows, to_device
from ..ops.select import block_decoder, check_encoder
from ..utils.profiling import trace_annotation
from . import distributed, framed

# A valid tag stream spends at most 6 bytes on one output byte (a literal
# tag with 4 length bytes and a 1-byte body), plus one ignored trailing byte.
MAX_TAG_BYTES_PER_BYTE = 6


def dispatch_compress(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, device="cuda", mesh=None,
                      encoder: str = "kernel"):
    """Launch the encode of every block of ``data`` with the block encoder
    ``encoder`` (``select.ENCODERS``) on ``device`` (or over ``mesh``);
    encode the routed blocks and take every block's crc on the host
    meanwhile. Returns a ticket for ``assemble_compress``."""
    check_encoder(encoder)
    bs = config.block_size
    if not 1 <= bs <= 1 << 16:
        raise ValueError("block_size must be in [1, 65536]")
    inp = as_u8(data)
    if len(inp) == 0:
        return (inp, config, None, None, [])
    with trace_annotation("framed.dispatch_compress"):
        if mesh is None:
            buf, blens = blockify(inp, bs)
            kind = "routed"
            part = route.dispatch_routed(buf, blens, route.host_blocks(buf, blens), device, config.min_profit,
                                         encoder)
        else:
            n_blocks = -(-len(inp) // bs)
            buf, blens = blockify(inp, bs, distributed.pad_block_count(n_blocks, mesh.size))
            kind = "mesh"
            part = (distributed.compress_blocks(buf, blens, mesh, min_profit=config.min_profit, encoder=encoder),
                    n_blocks)
        crcs = [zlib.crc32(inp[i : i + bs]) for i in range(0, len(inp), bs)] if config.checksum else None
    return (inp, config, kind, part, crcs)


def mesh_streams(sharded, n_blocks: int) -> list[bytes]:
    """Wait for the shards of ``distributed.compress_blocks`` and return the
    tag streams of the first ``n_blocks`` rows, in block order."""
    outs, olens = sharded
    streams = [s for out, olen in zip(outs, olens) for s in route.device_streams(out, olen)]
    return streams[:n_blocks]


def assemble_compress(ticket) -> bytes:
    """Wait for the blocks of ``dispatch_compress`` and build the frame."""
    inp, config, kind, part, crcs = ticket
    with trace_annotation("framed.assemble_compress"):
        if kind is None:
            streams = []
        elif kind == "routed":
            streams = route.assemble_routed(part)
        else:
            streams = mesh_streams(*part)
        return framed.build_frame_header([len(s) for s in streams], crcs, len(inp), config) + b"".join(streams)


def compress_framed(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, device="cuda", mesh=None,
                    encoder: str = "kernel") -> bytes:
    """Compress into the framed container, block-parallel on ``device`` or
    sharded over ``mesh``, with the block encoder ``encoder``."""
    return assemble_compress(dispatch_compress(data, config, device, mesh, encoder))


def block_batch(buf: np.ndarray, starts: np.ndarray, clens: np.ndarray, ulens: np.ndarray, block_size: int,
                rows: int):
    """The block decoder's host-side arguments for the streams
    ``buf[starts[i] : starts[i] + clens[i]]`` of ``ulens[i]`` bytes, padded
    with empty rows (clen = ulen = 0) to ``rows``: (comp uint8[rows, C],
    clens int32[rows], ulens int32[rows])."""
    n = len(starts)
    if n and int(clens.max()) > MAX_TAG_BYTES_PER_BYTE * block_size + 1:
        # No valid block is this long; refuse before sizing a batch by it.
        raise CorruptInputError("framed block longer than any valid tag stream")
    pad = np.zeros(rows - n, np.int64)
    comp = pack_rows(buf, np.concatenate([starts, pad]), np.concatenate([clens, pad]))
    return comp, np.concatenate([clens, pad]).astype(np.int32), np.concatenate([ulens, pad]).astype(np.int32)


def frame_batch(frame: bytes, idx: framed.FrameIndex, rows: int | None = None):
    """The block decoder's host-side arguments for a frame with at least
    one block: (comp uint8[rows, C], clens int32[rows], ulens int32[rows],
    out_size); ``rows`` defaults to the block count."""
    n = idx.n_blocks
    clens = idx.comp_lens.astype(np.int64)
    starts = idx.payload_start + np.concatenate([[0], np.cumsum(clens)[:-1]])
    ulens = np.full(n, idx.block_size, np.int64)
    ulens[-1] = idx.block_ulen(n - 1)
    buf = np.frombuffer(frame, np.uint8)
    return (*block_batch(buf, starts, clens, ulens, idx.block_size, n if rows is None else rows), int(idx.block_size))


def dispatch_uncompress(frame: bytes, device="cuda", mesh=None):
    """Launch the decode of every block of ``frame`` on ``device`` (or over
    ``mesh``). Returns a ticket for ``assemble_uncompress``."""
    idx = framed.parse_index(frame)
    if idx.n_blocks == 0:
        return (idx, None, None)
    if mesh is None:
        comp, clens, ulens, out_size = frame_batch(frame, idx)
        with trace_annotation("framed.dispatch_uncompress"):
            out, ok, _ = block_decoder(device)(
                to_device(comp, device),
                to_device(clens, device),
                to_device(ulens, device),
                out_size,
            )
        return (idx, [out], [ok])
    comp, clens, ulens, out_size = frame_batch(frame, idx, distributed.pad_block_count(idx.n_blocks, mesh.size))
    with trace_annotation("framed.dispatch_uncompress"):
        outs, oks, _ = distributed.decompress_blocks(comp, clens, ulens, mesh, out_size)
    return (idx, outs, oks)


def join_rows(parts: list[torch.Tensor]) -> np.ndarray:
    """The rows of the shards ``parts``, in order, as one host array: each
    shard is copied back once, into its place."""
    if len(parts) == 1:
        return parts[0].cpu().numpy()
    rows = torch.empty((sum(len(p) for p in parts), *parts[0].shape[1:]), dtype=parts[0].dtype)
    lo = 0
    for p in parts:
        rows[lo : lo + len(p)].copy_(p)
        lo += len(p)
    return rows.numpy()


def assemble_uncompress(ticket) -> bytes:
    """Wait for the blocks of ``dispatch_uncompress``, validate them and
    join them. Raises CorruptInputError on a block that did not decode or
    whose crc does not match."""
    idx, outs, oks = ticket
    if idx.n_blocks == 0:
        return b""
    with trace_annotation("framed.assemble_uncompress"):
        ok = join_rows(oks)[: idx.n_blocks]
        if not ok.all():
            raise CorruptInputError(f"corrupt framed block {int(np.flatnonzero(~ok)[0])}")
        # Rows are block_size wide and each holds its block, so the stream
        # is the rows joined, cut at total_len.
        body = join_rows(outs).reshape(-1)[: idx.total_len]
        bs = int(idx.block_size)
        framed.verify_crcs(idx, [body[i * bs : (i + 1) * bs] for i in range(idx.n_blocks)])
        return body.tobytes()


def uncompress_framed(frame: bytes, device="cuda", mesh=None) -> bytes:
    """Decode a framed stream block-parallel on ``device`` or sharded over
    ``mesh``."""
    return assemble_uncompress(dispatch_uncompress(frame, device, mesh))
