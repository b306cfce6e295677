"""Host driver of framed decode on one device.

The counterpart of ``snappy_tpu/parallel/host.py:106-164``, without a mesh.
``dispatch_uncompress`` packs the frame's blocks into one batch, copies it
to the device and launches the block decoder, which runs asynchronously on
the current stream; ``assemble_uncompress`` waits for it, checks every
block's ``ok`` flag and crc, and joins the blocks. The split lets a
pipeline prepare frame k+1 while the device decodes frame k.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import CorruptInputError
from ..ops.host import pack_rows, to_device
from ..ops.select import block_decoder
from ..utils.profiling import trace_annotation
from . import framed

# A valid tag stream spends at most 6 bytes on one output byte (a literal
# tag with 4 length bytes and a 1-byte body), plus one ignored trailing byte.
MAX_TAG_BYTES_PER_BYTE = 6


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
