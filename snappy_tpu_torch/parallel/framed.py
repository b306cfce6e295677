"""Framed container: the parallel-decodable stream format.

Byte for byte the format of ``snappy_tpu/parallel/framed.py``, so frames
written by either package read in the other. The raw Snappy format is one
sequential tag stream; the frame records what it throws away, per-block
compressed sizes and checksums, which makes decode embarrassingly parallel
(each block is an independent headerless tag stream) and resumable at any
block boundary.

Layout (all little-endian):

    magic      8s   b"SNPTPU01"
    flags      u32  bit0 = per-block crc32 of the uncompressed block
    block_size u32  uncompressed bytes per block (last may be short)
    total_len  u64  uncompressed stream length
    n_blocks   u32
    index      n_blocks * u32          compressed byte length per block
    [crcs      n_blocks * u32]         if flags&1
    payload    concatenated headerless block tag streams

The payload blocks are the blocks a raw stream would contain, so
``frame_to_raw`` is a reframing that never touches block bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..core import varint
from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..native import runtime as nat
from ..ops.host import HOST_POOL, HOST_THREADS
from ..utils.profiling import count, trace_annotation

MAGIC = b"SNPTPU01"
_HEADER = struct.Struct("<8sIIQI")
FLAG_CRC = 1


def crc32s(blocks: list) -> list[int]:
    """``zlib.crc32`` of each of ``blocks`` (bytes-like, contiguous), in
    order: the blocks cut into one run a thread of ``HOST_POOL``, each run
    one native call (``native.runtime.crc32_rows``), which holds no
    interpreter lock. zlib.crc32 releases it too, but a call a 64 KiB block
    hands the lock over so often that threads of such calls run no faster
    than one: without the native library the crcs run on this thread. Runs
    in the span ``framed.crc`` and counts the bytes under
    ``framed.crc_bytes``."""
    with trace_annotation("framed.crc"):
        if len(blocks) < 2 or not nat.available():
            count("framed.crc_bytes", sum(memoryview(b).nbytes for b in blocks))
            return [zlib.crc32(b) for b in blocks]
        views = [np.frombuffer(b, np.uint8) for b in blocks]
        ptrs = np.fromiter((v.ctypes.data for v in views), np.uint64, len(views))
        lens = np.fromiter((v.size for v in views), np.int64, len(views))
        count("framed.crc_bytes", int(lens.sum()))
        out = np.empty(len(views), np.uint32)
        per = -(-len(views) // HOST_THREADS)
        runs = [slice(i, i + per) for i in range(0, len(views), per)]
        list(HOST_POOL.map(lambda r: nat.crc32_rows(ptrs[r], lens[r], out[r]), runs))
        return out.tolist()


class FrameIndex:
    """Parsed frame header + block index (host-side metadata)."""

    __slots__ = ("flags", "block_size", "total_len", "comp_lens", "crcs", "payload_start")

    def __init__(self, flags, block_size, total_len, comp_lens, crcs, payload_start):
        self.flags = flags
        self.block_size = block_size
        self.total_len = total_len
        self.comp_lens = comp_lens
        self.crcs = crcs
        self.payload_start = payload_start

    @property
    def n_blocks(self) -> int:
        return len(self.comp_lens)

    def block_ranges(self) -> list[tuple[int, int]]:
        """(start, end) byte range of each block's tag stream in the frame."""
        out = []
        off = self.payload_start
        for cl in self.comp_lens:
            out.append((off, off + int(cl)))
            off += int(cl)
        return out

    def block_ulen(self, i: int) -> int:
        if i < self.n_blocks - 1:
            return self.block_size
        return self.total_len - self.block_size * (self.n_blocks - 1)


def parse_index(frame: bytes, require_payload: bool = True) -> FrameIndex:
    """Parse header + index, and check that the payload is all there.
    ``require_payload=False`` validates the header and index alone, for a
    reader that fetches payload ranges separately (``multihost.py``). Runs
    in the span ``framed.parse``."""
    with trace_annotation("framed.parse"):
        if len(frame) < _HEADER.size:
            raise CorruptInputError("frame too short")
        magic, flags, block_size, total_len, n_blocks = _HEADER.unpack_from(frame, 0)
        if magic != MAGIC:
            raise CorruptInputError("bad frame magic")
        if block_size < 1 or block_size > 1 << 16:
            raise CorruptInputError("bad frame block size")
        expect_blocks = -(-total_len // block_size) if total_len else 0
        if n_blocks != expect_blocks:
            raise CorruptInputError("frame block count mismatch")
        off = _HEADER.size
        index_len = 4 * n_blocks * (2 if flags & FLAG_CRC else 1)
        if off + index_len > len(frame):
            raise CorruptInputError("frame index truncated")
        comp_lens = np.frombuffer(frame, np.uint32, n_blocks, off)
        off += 4 * n_blocks
        crcs = None
        if flags & FLAG_CRC:
            crcs = np.frombuffer(frame, np.uint32, n_blocks, off)
            off += 4 * n_blocks
        if require_payload and off + int(comp_lens.sum(dtype=np.int64)) > len(frame):
            raise CorruptInputError("frame payload truncated")
        return FrameIndex(flags, block_size, total_len, comp_lens, crcs, off)


def build_frame_header(
    comp_lens: list[int],
    crcs: list[int] | None,
    total_len: int,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
) -> bytes:
    """Header + index only (no payload)."""
    flags = FLAG_CRC if config.checksum else 0
    parts = [
        _HEADER.pack(MAGIC, flags, config.block_size, total_len, len(comp_lens)),
        np.array(comp_lens, np.uint32).tobytes(),
    ]
    if config.checksum:
        if crcs is None:
            raise ValueError("config.checksum is set but no crcs were given")
        parts.append(np.array(crcs, np.uint32).tobytes())
    return b"".join(parts)


def build_frame(
    block_streams: list[bytes],
    block_raws: list[bytes] | None,
    total_len: int,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
) -> bytes:
    """Assemble a frame from per-block tag streams (+ raw blocks for crcs)."""
    crcs = crc32s(block_raws) if config.checksum else None
    header = build_frame_header([len(s) for s in block_streams], crcs, total_len, config)
    return header + b"".join(block_streams)


def verify_crcs_range(idx: FrameIndex, blocks_out: list, first_block: int) -> None:
    """verify_crcs for a contiguous slice of blocks starting at
    ``first_block``."""
    if idx.crcs is None:
        return
    want = idx.crcs[first_block : first_block + len(blocks_out)]
    bad = np.flatnonzero(np.array(crc32s(blocks_out), np.uint32) != want)
    if len(bad):
        raise CorruptInputError(f"crc mismatch in block {first_block + int(bad[0])}")


def verify_crcs(idx: FrameIndex, blocks_out: list) -> None:
    """Raise CorruptInputError unless every decoded block matches its crc."""
    verify_crcs_range(idx, blocks_out, 0)


def frame_to_raw(frame: bytes) -> bytes:
    """Reframe to the wire-compatible raw stream: varint header + the very
    same block tag streams, concatenated."""
    idx = parse_index(frame)
    parts = [varint.encode32(idx.total_len)]
    for s, e in idx.block_ranges():
        parts.append(frame[s:e])
    return b"".join(parts)


def raw_to_frame(raw: bytes, config: FrameConfig = DEFAULT_FRAME_CONFIG, *, device="cuda") -> bytes:
    """Reframe a raw stream into a frame.

    Where the native segmenter cuts the stream into segments of exactly
    ``block_size`` output bytes (the streams of every block-based encoder),
    the frame reuses the segment bytes as they are, and the stream is
    decoded on the host only for the crcs. Any other stream, and every
    stream where the native library cannot load, is decoded on the host
    (``api.uncompress``) and compressed again with ``compress_framed`` on
    ``device``.
    """
    comp = np.frombuffer(raw, np.uint8)
    ulen, start = varint.parse32(comp, 0)
    bs = config.block_size
    segment = bs == 1 << 16 and ulen and nat.available()
    seg = nat.scan_blocks(comp[start:], ulen) if segment else None
    if seg is not None and len(seg[0]) and (seg[1][:-1] == bs).all() and seg[1][-1] <= bs:
        bounds = [*seg[0].tolist(), len(comp) - start]
        body = raw[start:]
        streams = [body[bounds[i] : bounds[i + 1]] for i in range(len(seg[0]))]
        raws = None
        if config.checksum:
            out = nat.uncompress(raw)
            raws = [out[i : i + bs] for i in range(0, len(out), bs)]
        return build_frame(streams, raws, ulen, config)
    from ..api import uncompress
    from .host import compress_framed  # host builds on this module

    return compress_framed(uncompress(raw), config, device=device)
