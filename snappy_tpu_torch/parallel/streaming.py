"""Streaming pipeline for streams larger than memory.

The counterpart of ``snappy_tpu/parallel/streaming.py``, on one device or
over a mesh (``mesh=``, passed through to ``host.py``). A stream is a
sequence of self-delimiting frames (``parallel/framed.py``),
each covering up to ``blocks_per_frame`` blocks, byte for byte the
reference's format, so a sequence written or torn by either package reads
and resumes in the other. The pipeline keeps a bounded queue of in-flight
dispatches (``parallel/host.py``): a dispatch queues its copy in, its
kernel and the copy of its results into pinned host memory on the current
CUDA stream, records an event after them and returns without waiting for
the card, so while the card codes chunk k the host reads chunk k+1, and
assembles and writes frame k-d, waiting for that frame's event alone.
Memory, pinned buffers included, stays bounded by ``PIPELINE_DEPTH`` + 1
frames. The reads of ``src`` and the writes to ``dst`` run in the spans
``stream.read`` and ``stream.write``.

Recovery: blocks are stateless and idempotent, so a frame whose decode
fails with anything but ``CorruptInputError`` (a fault on the card raises
at the frame's event wait) is dispatched again from the frame bytes the
pipeline still holds, up to ``max_retries`` times, before
the error is raised. Corrupt data fails the same way every time and is
never retried. ``uncompress_stream`` counts retries in ``last_stats``.

Resume after a kill: the frame sequence is its own checkpoint. Frames are
written in order, so the durable prefix of whole frames is found by a scan,
and work restarts from the first missing or torn frame.
"""

from __future__ import annotations

import os
from collections import deque
from typing import BinaryIO, Iterator

import numpy as np

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..ops.select import check_encoder
from ..utils.profiling import trace_annotation
from . import framed
from . import host as _host

DEFAULT_BLOCKS_PER_FRAME = 32
# In-flight dispatches. 2 = double-buffering: one frame assembled on the
# host while the next computes on the device.
PIPELINE_DEPTH = 2

#: stats of the most recent uncompress_stream call: {"frames": n, "retries": n}
last_stats: dict = {}


class _TornFrame(CorruptInputError):
    """The stream ends inside a frame."""


def _read_frame(src: BinaryIO) -> tuple[bytes, int] | None:
    """The next frame of ``src`` and the uncompressed bytes it covers, or
    None where the stream ends between frames. Raises _TornFrame where it
    ends inside one, and CorruptInputError on a whole header without the
    frame magic."""
    head = src.read(framed._HEADER.size)
    if not head:
        return None
    if len(head) < framed._HEADER.size:
        raise _TornFrame("torn frame header")
    magic, flags, _block_size, total_len, n_blocks = framed._HEADER.unpack(head)
    if magic != framed.MAGIC:
        raise CorruptInputError("bad frame magic in stream")
    index_bytes = 4 * n_blocks * (2 if flags & framed.FLAG_CRC else 1)
    index = src.read(index_bytes)
    if len(index) < index_bytes:
        raise _TornFrame("torn frame index")
    payload_bytes = int(np.frombuffer(index, np.uint32, n_blocks).sum(dtype=np.int64))
    payload = src.read(payload_bytes)
    if len(payload) < payload_bytes:
        raise _TornFrame("torn frame payload")
    return head + index + payload, total_len


def _durable_frames(path: str) -> Iterator[tuple[int, int]]:
    """(frame bytes, uncompressed bytes) of each whole frame of the file at
    ``path``, in order, up to its end or a torn tail; nothing for a file
    that does not exist."""
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return
    with f:
        while True:
            try:
                got = _read_frame(f)
            except _TornFrame:
                return
            if got is None:
                return
            yield len(got[0]), got[1]


def compress_stream(
    src: BinaryIO,
    dst: BinaryIO,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
    mesh=None,
    blocks_per_frame: int = DEFAULT_BLOCKS_PER_FRAME,
    *,
    device="cuda",
    encoder: str = "kernel",
) -> int:
    """Compress ``src`` into a sequence of frames on ``dst``, coded on
    ``device`` (or sharded over ``mesh``, see ``host.py``) with the block
    encoder ``encoder``. Returns the compressed bytes written."""
    check_encoder(encoder)
    chunk_bytes = blocks_per_frame * config.block_size
    total = 0
    pending: deque = deque()
    eof = False
    while not eof or pending:
        if not eof:
            with trace_annotation("stream.read"):
                chunk = src.read(chunk_bytes)
            if chunk:
                pending.append(_host.dispatch_compress(chunk, config, mesh, device=device, encoder=encoder))
            else:
                eof = True
        while pending and (len(pending) > PIPELINE_DEPTH or eof):
            frame = _host.assemble_compress(pending.popleft())
            with trace_annotation("stream.write"):
                dst.write(frame)
            total += len(frame)
    return total


def iter_frames(src: BinaryIO) -> Iterator[bytes]:
    """Yield the frames of a frame-sequence stream. Raises CorruptInputError
    on a torn frame or a header without the frame magic."""
    while (got := _read_frame(src)) is not None:
        yield got[0]


def uncompress_stream(src: BinaryIO, dst: BinaryIO, mesh=None, max_retries: int = 1, *, device="cuda") -> int:
    """Decode a frame-sequence stream on ``device`` (or over ``mesh``);
    returns the uncompressed bytes written. ``dst.write`` gets each frame's
    bytes as a ``memoryview`` of the host memory they came back in, which
    stays valid for as long as the sink keeps it.

    A frame whose decode fails is dispatched again up to ``max_retries``
    times from its frame bytes before the error propagates; a
    CorruptInputError propagates at once.
    """
    global last_stats
    total = 0
    frames = 0
    retries = 0
    retry_exc: str | None = None
    pending: deque = deque()  # (frame bytes, ticket)

    def commit(frame_bytes, ticket) -> memoryview:
        nonlocal retries, retry_exc
        for attempt in range(max_retries + 1):
            try:
                return memoryview(_host.assemble_uncompress_array(ticket))
            except CorruptInputError:
                # Corrupt data decodes the same way every time: a second
                # dispatch cannot succeed.
                raise
            except Exception as e:
                if attempt == max_retries:
                    raise
                retries += 1
                retry_exc = type(e).__name__
                ticket = _host.dispatch_uncompress(frame_bytes, mesh, device=device)
        raise AssertionError("unreachable")

    it = iter_frames(src)
    eof = False
    while not eof or pending:
        if not eof:
            with trace_annotation("stream.read"):
                frame = next(it, None)
            if frame is None:
                eof = True
            else:
                pending.append((frame, _host.dispatch_uncompress(frame, mesh, device=device)))
        while pending and (len(pending) > PIPELINE_DEPTH or eof):
            out = commit(*pending.popleft())
            with trace_annotation("stream.write"):
                dst.write(out)
            total += len(out)
            frames += 1
    last_stats = {"frames": frames, "retries": retries}
    if retry_exc is not None:
        last_stats["last_retry_exception"] = retry_exc
    return total


def compress_file(in_path: str, out_path: str, **kw) -> int:
    with open(in_path, "rb") as src, open(out_path, "wb") as dst:
        return compress_stream(src, dst, **kw)


def uncompress_file(in_path: str, out_path: str, **kw) -> int:
    with open(in_path, "rb") as src, open(out_path, "wb") as dst:
        return uncompress_stream(src, dst, **kw)


def scan_durable_frames(path: str) -> tuple[int, int, int]:
    """Scan a frame-sequence file that a kill may have torn.

    Returns (durable_bytes, n_frames, covered_output_bytes): the length of
    the longest prefix of whole frames, how many frames it holds and how
    many uncompressed bytes they cover. A torn tail is not counted. Raises
    CorruptInputError only on a whole header without the frame magic.
    """
    durable = frames = covered = 0
    for size, total_len in _durable_frames(path):
        durable += size
        frames += 1
        covered += total_len
    return durable, frames, covered


def _full_chunk_prefix(path: str, chunk: int) -> tuple[int, int]:
    """Longest prefix of whole frames that each cover exactly ``chunk``
    input bytes: (durable_bytes, covered_input_bytes). A short or torn
    frame, and everything after it, is not counted; resume does it again."""
    durable = covered = 0
    for size, total_len in _durable_frames(path):
        if total_len != chunk:
            break
        durable += size
        covered += total_len
    return durable, covered


def _truncate(path: str, size: int) -> None:
    """Cut (or extend with zeros, creating it) the file at ``path`` to
    ``size`` bytes."""
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, size)
    finally:
        os.close(fd)


def resume_compress_file(
    in_path: str,
    out_path: str,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
    mesh=None,
    blocks_per_frame: int = DEFAULT_BLOCKS_PER_FRAME,
    *,
    device="cuda",
    encoder: str = "kernel",
) -> int:
    """Compress ``in_path`` to a frame sequence at ``out_path`` on
    ``device`` (or over ``mesh``) with the block encoder ``encoder``,
    resuming from the last durable frame where an earlier run died
    mid-stream. Returns the compressed size. Restartable any number of
    times; a first run is the resume of nothing."""
    check_encoder(encoder)
    durable, _, covered = scan_durable_frames(out_path)
    chunk = blocks_per_frame * config.block_size
    if covered % chunk:
        # The durable prefix ends in a short frame. Where it completes the
        # input, the earlier run finished: keep it, without any torn tail.
        if covered == os.path.getsize(in_path):
            if durable != os.path.getsize(out_path):
                _truncate(out_path, durable)
            return durable
        # Otherwise more input remains (the input grew after a finished run,
        # or the frame geometry changed): drop the short frame and restart
        # from the longest prefix of whole chunks.
        durable, covered = _full_chunk_prefix(out_path, chunk)
    with open(in_path, "rb") as src:
        src.seek(covered)
        _truncate(out_path, durable)
        with open(out_path, "r+b") as dst:
            dst.seek(durable)
            written = compress_stream(src, dst, config, mesh, blocks_per_frame, device=device, encoder=encoder)
    return durable + written


def resume_uncompress_file(in_path: str, out_path: str, mesh=None, *, device="cuda", **kw) -> int:
    """Decode a frame-sequence file on ``device`` (or over ``mesh``),
    resuming after a kill.

    The output file is its own progress marker: frames decode in order and
    append, so a kill leaves a prefix, possibly torn; resume cuts it to the
    last whole frame and decodes the frames after it. Returns the
    uncompressed size. ``kw`` (``max_retries``, say) is taken and not used,
    as in the reference: resume does not retry a frame, it is itself the
    retry of a run that died."""
    try:
        out_size = os.path.getsize(out_path)
    except FileNotFoundError:
        out_size = 0
    skip_frames = done = 0
    with open(in_path, "rb") as src:
        for frame in iter_frames(src):
            tl = framed._HEADER.unpack_from(frame, 0)[3]
            if done + tl > out_size:
                break
            done += tl
            skip_frames += 1
    _truncate(out_path, done)

    total = done
    with open(in_path, "rb") as src, open(out_path, "r+b") as dst:
        it = iter_frames(src)
        for _ in range(skip_frames):
            next(it)
        dst.seek(done)
        pending: deque = deque()
        eof = False
        while not eof or pending:
            if not eof:
                frame = next(it, None)
                if frame is None:
                    eof = True
                else:
                    pending.append(_host.dispatch_uncompress(frame, mesh, device=device))
            while pending and (len(pending) > PIPELINE_DEPTH or eof):
                out = memoryview(_host.assemble_uncompress_array(pending.popleft()))
                dst.write(out)
                total += len(out)
    return total
