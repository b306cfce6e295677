"""Host driver of framed encode and decode, on one device or over a mesh.

The counterpart of ``snappy_tpu/parallel/host.py``. ``dispatch_compress``
cuts the stream into blocks, routes the incompressible ones to the host
encoder and launches the block encoder on the rest, asynchronously on the
current stream; ``assemble_compress`` waits for it and builds the frame.
``dispatch_uncompress`` copies the frame's payload to the device, builds
the batch's rows there and launches the block decoder; ``assemble_uncompress``
waits for it, checks every block's ``ok`` flag and crc, and joins the
blocks. The splits let a pipeline prepare frame k+1 while the device works
on frame k: each dispatch queues the copy of its results to the host behind
its launch, with an event of its own (``ops.host.HostCopy``), so an
assemble waits for its own frame and not for the frames queued after it.
Crcs run on a thread a core (``framed.crc32s``).

With ``mesh=`` (``distributed.mesh_1d``) the batch is padded to a multiple
of the mesh size and sharded over its devices, one launch a shard, and
``device`` is not used. As in the reference, the mesh path routes no
block: every block is encoded on the devices, so a frame with
incompressible blocks may differ from the routed one (both are valid). The
frame is a function of the data and the config alone, never of the mesh.
"""

from __future__ import annotations

import numpy as np

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..ops import route
from ..ops.host import HostCopy, as_u8, blockify, pack_batch
from ..ops.select import block_decoder, check_encoder
from ..utils.profiling import trace_annotation
from . import distributed, framed

# A valid tag stream spends at most 6 bytes on one output byte (a literal
# tag with 4 length bytes and a 1-byte body), plus one ignored trailing byte.
MAX_TAG_BYTES_PER_BYTE = 6


def dispatch_compress(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, mesh=None, *, device="cuda",
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
            sharded = distributed.compress_blocks(buf, blens, mesh, min_profit=config.min_profit, encoder=encoder)
            part = (distributed.to_host(sharded), n_blocks)
        crcs = framed.crc32s([inp[i : i + bs] for i in range(0, len(inp), bs)]) if config.checksum else None
    return (inp, config, kind, part, crcs)


def mesh_streams(copies: list[HostCopy], n_blocks: int) -> list[bytes]:
    """Wait for each shard's results (``distributed.to_host`` of
    ``compress_blocks``) and return the tag streams of the first
    ``n_blocks`` rows, in block order."""
    streams = [s for c in copies for s in route.device_streams(*c.wait())]
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


def compress_framed(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, mesh=None, *, device="cuda",
                    encoder: str = "kernel") -> bytes:
    """Compress into the framed container, block-parallel on ``device`` or
    sharded over ``mesh``, with the block encoder ``encoder``."""
    return assemble_compress(dispatch_compress(data, config, mesh, device=device, encoder=encoder))


def block_batch(span: np.ndarray, clens: np.ndarray, ulens: np.ndarray, block_size: int, rows: int, device="cpu"):
    """The block decoder's arguments, on ``device``, for the streams that
    lie end to end in ``span``, ``clens[i]`` bytes each, of ``ulens[i]``
    bytes, padded with empty rows (clen = ulen = 0) to ``rows``: (comp
    uint8[rows, C], clens int32[rows], ulens int32[rows]); the rows are
    ``pack_rows``'s, built on the device (``ops.host.pack_batch``)."""
    if len(clens) and int(clens.max()) > MAX_TAG_BYTES_PER_BYTE * block_size + 1:
        # No valid block is this long; refuse before sizing a batch by it.
        raise CorruptInputError("framed block longer than any valid tag stream")
    return pack_batch(span, clens, ulens, rows, device)


def frame_batch(frame: bytes, idx: framed.FrameIndex, rows: int | None = None, device="cpu"):
    """The block decoder's arguments, on ``device``, for a frame with at
    least one block: (comp uint8[rows, C], clens int32[rows], ulens
    int32[rows], out_size); ``rows`` defaults to the block count. Every
    size comes from the index, so nothing waits for the device."""
    n = idx.n_blocks
    clens = idx.comp_lens.astype(np.int64)
    ulens = np.full(n, idx.block_size, np.int64)
    ulens[-1] = idx.block_ulen(n - 1)
    # The blocks' streams lie end to end in the payload.
    span = np.frombuffer(frame, np.uint8, int(clens.sum()), idx.payload_start)
    batch = block_batch(span, clens, ulens, idx.block_size, n if rows is None else rows, device)
    return (*batch, int(idx.block_size))


def dispatch_uncompress(frame: bytes, mesh=None, *, device="cuda"):
    """Launch the decode of every block of ``frame`` on ``device`` (or over
    ``mesh``) and queue the copy of its results to the host. Returns a
    ticket for ``assemble_uncompress``."""
    with trace_annotation("framed.dispatch_uncompress"):
        idx = framed.parse_index(frame)
        if idx.n_blocks == 0:
            return (idx, None)
        if mesh is None:
            return (idx, [HostCopy(block_decoder(device)(*frame_batch(frame, idx, device=device)))])
        # The rows are built on the first device of the mesh and each shard
        # goes to its own from there.
        comp, clens, ulens, out_size = frame_batch(frame, idx, distributed.pad_block_count(idx.n_blocks, mesh.size),
                                                   mesh.devices[0])
        return (idx, distributed.to_host(distributed.decompress_blocks(comp, clens, ulens, mesh, out_size)))


def join_rows(parts: list[np.ndarray]) -> np.ndarray:
    """The rows of the shards ``parts``, in order, as one host array."""
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def assemble_uncompress_array(ticket) -> np.ndarray:
    """Wait for the blocks of ``dispatch_uncompress``, validate them and
    return the stream they decode to as a uint8 host array: on a card, a
    view of the pinned memory its rows came back in, which a stream writes
    out without another copy. Raises CorruptInputError on a block that did
    not decode or whose crc does not match."""
    idx, copies = ticket
    if idx.n_blocks == 0:
        return np.zeros(0, np.uint8)
    with trace_annotation("framed.assemble_uncompress"):
        outs, oks, _ = zip(*(c.wait() for c in copies))
        ok = join_rows(oks)[: idx.n_blocks]
        if not ok.all():
            raise CorruptInputError(f"corrupt framed block {int(np.flatnonzero(~ok)[0])}")
        # Rows are block_size wide and each holds its block, so the stream
        # is the rows joined, cut at total_len.
        with trace_annotation("framed.join"):
            body = join_rows(outs).reshape(-1)[: idx.total_len]
        bs = int(idx.block_size)
        framed.verify_crcs(idx, [body[i * bs : (i + 1) * bs] for i in range(idx.n_blocks)])
        return body


def assemble_uncompress(ticket) -> bytes:
    """``assemble_uncompress_array`` as bytes, the copy in the span
    ``framed.join``."""
    body = assemble_uncompress_array(ticket)
    with trace_annotation("framed.join"):
        return body.tobytes()


def uncompress_framed(frame: bytes, mesh=None, *, device="cuda") -> bytes:
    """Decode a framed stream block-parallel on ``device`` or sharded over
    ``mesh``."""
    return assemble_uncompress(dispatch_uncompress(frame, mesh, device=device))
