"""Host driver of framed encode and decode on one device.

The counterpart of ``snappy_tpu/parallel/host.py``, without a mesh.
``dispatch_compress`` cuts the stream into blocks, routes the
incompressible ones to the host encoder and launches the block encoder on
the rest, asynchronously on the current stream; ``assemble_compress`` waits
for it and builds the frame. ``dispatch_uncompress`` packs the frame's
blocks into one batch, copies it to the device and launches the block
decoder; ``assemble_uncompress`` waits for it, checks every block's ``ok``
flag and crc, and joins the blocks. The splits let a pipeline prepare
frame k+1 while the device works on frame k.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..ops import route
from ..ops.host import as_u8, blockify, pack_rows, to_device
from ..ops.select import block_decoder
from ..utils.profiling import trace_annotation
from . import framed

# A valid tag stream spends at most 6 bytes on one output byte (a literal
# tag with 4 length bytes and a 1-byte body), plus one ignored trailing byte.
MAX_TAG_BYTES_PER_BYTE = 6


def dispatch_compress(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, device="cuda"):
    """Launch the encode of every block of ``data`` on ``device``; encode
    the routed blocks and take every block's crc on the host meanwhile.
    Returns a ticket for ``assemble_compress``."""
    bs = config.block_size
    if not 1 <= bs <= 1 << 16:
        raise ValueError("block_size must be in [1, 65536]")
    inp = as_u8(data)
    if len(inp) == 0:
        return (inp, config, None, [])
    with trace_annotation("framed.dispatch_compress"):
        buf, blens = blockify(inp, bs)
        routed = route.dispatch_routed(buf, blens, route.host_blocks(buf, blens), device, config.min_profit)
        crcs = [zlib.crc32(inp[i : i + bs]) for i in range(0, len(inp), bs)] if config.checksum else None
    return (inp, config, routed, crcs)


def assemble_compress(ticket) -> bytes:
    """Wait for the blocks of ``dispatch_compress`` and build the frame."""
    inp, config, routed, crcs = ticket
    with trace_annotation("framed.assemble_compress"):
        streams = route.assemble_routed(routed) if routed is not None else []
        return framed.build_frame_header([len(s) for s in streams], crcs, len(inp), config) + b"".join(streams)


def compress_framed(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, device="cuda") -> bytes:
    """Compress into the framed container, block-parallel on ``device``."""
    return assemble_compress(dispatch_compress(data, config, device))


def frame_batch(frame: bytes, idx: framed.FrameIndex):
    """The block decoder's host-side arguments for a frame with at least
    one block: (comp uint8[n, C], clens int32[n], ulens int32[n], out_size)."""
    n = idx.n_blocks
    clens = idx.comp_lens.astype(np.int64)
    if int(clens.max()) > MAX_TAG_BYTES_PER_BYTE * idx.block_size + 1:
        # No valid block is this long; refuse before sizing a batch by it.
        raise CorruptInputError("framed block longer than any valid tag stream")
    starts = idx.payload_start + np.concatenate([[0], np.cumsum(clens)[:-1]])
    comp = pack_rows(np.frombuffer(frame, np.uint8), starts, clens)
    ulens = np.full(n, idx.block_size, np.int32)
    ulens[-1] = idx.block_ulen(n - 1)
    return comp, clens.astype(np.int32), ulens, int(idx.block_size)


def dispatch_uncompress(frame: bytes, device="cuda"):
    """Launch the decode of every block of ``frame`` on ``device``.
    Returns a ticket for ``assemble_uncompress``."""
    idx = framed.parse_index(frame)
    if idx.n_blocks == 0:
        return (idx, None, None)
    comp, clens, ulens, out_size = frame_batch(frame, idx)
    with trace_annotation("framed.dispatch_uncompress"):
        out, ok, _ = block_decoder(device)(
            to_device(comp, device),
            to_device(clens, device),
            to_device(ulens, device),
            out_size,
        )
    return (idx, out, ok)


def assemble_uncompress(ticket) -> bytes:
    """Wait for the blocks of ``dispatch_uncompress``, validate them and
    join them. Raises CorruptInputError on a block that did not decode or
    whose crc does not match."""
    idx, out, ok = ticket
    if idx.n_blocks == 0:
        return b""
    with trace_annotation("framed.assemble_uncompress"):
        ok = ok.cpu().numpy()
        if not ok.all():
            raise CorruptInputError(f"corrupt framed block {int(np.flatnonzero(~ok)[0])}")
        # Rows are block_size wide and each holds its block, so the stream
        # is the rows joined, cut at total_len.
        body = out.cpu().numpy().reshape(-1)[: idx.total_len]
        bs = int(idx.block_size)
        framed.verify_crcs(idx, [body[i * bs : (i + 1) * bs] for i in range(idx.n_blocks)])
        return body.tobytes()


def uncompress_framed(frame: bytes, device="cuda") -> bytes:
    """Decode a framed stream block-parallel on ``device``."""
    return assemble_uncompress(dispatch_uncompress(frame, device))
