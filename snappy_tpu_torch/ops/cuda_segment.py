"""Stream segmenter on the card (K4): the wrapper of ``csrc/segment_streams.cu``,
and its plain version.

``segment_streams(comp, starts, clens, ulens, out_starts, out_len)``
cuts each of n raw Snappy streams that lie in the uint8 buffer
``comp`` (stream i: ``clens[i]`` bytes at ``starts[i]``, varint header
included, stated to decode to ``ulens[i]`` bytes at ``out_starts[i]`` of an
output of ``out_len`` bytes) into rows of K1's ragged variant
(``cuda_decode.decode_segments``), by the rule of the native
``scan_blocks`` (``native/snappy_native.cpp``):

- a segment starts at the first tag boundary at or after every 64 KiB of
  output since the last segment's start, and is merged into the one before
  it where a copy reaches behind its start;
- a stream that cannot be cut into segments of at most 128 KiB of output
  (or holds a copy offset above 0x1ffff or a literal above 0x1fff8 bytes)
  is one row, the whole body;
- a stream whose header is not a varint32 equal to ``ulens[i]``, that lies
  outside its buffers, or that the scan proves corrupt, is not ok and has
  no rows.

Stream i reserves ``ceil(ulens[i] / 65536)`` rows of a table of
``capacity_for(n, out_len)`` rows, which holds every reservation of
streams whose outputs lie apart (a stream whose rows would pass the table
is not ok); the rows it does not fill are empty (clen = ulen = 0). It
returns ``(rows, stream_ok, stats)``: ``rows`` the table's columns (in
int64, out int64 as offsets into ``comp`` and the output, clen int32,
ulen int32, stream int32; [capacity]), ``stream_ok`` uint8[n], and
``stats`` int64[7]: rows reserved (the rows the table holds, first), rows
that hold a segment, boundaries merged away, streams taken whole; then the
kernel's slices of long streams: charted, met (the join found the true
chain on a record of the slice's chart, or never entered it) and walked
(the join stepped a tag of it by the scan's rule). The plain version
charts no slices: its last three are 0.

A CUDA buffer launches the kernel on the current stream and returns
without synchronising; the table's row order is the order in which the
streams reserved their rows. The kernel's scratch (its counts and list of
long streams, zeroed, and a summary a slice) is sized from n and the
buffer's length. A CPU buffer runs ``segment_streams_plain``, which
reserves in stream order. The counters ``streams.streams``,
``streams.segments``, ``streams.merged``, ``streams.whole``,
``streams.slices``, ``streams.slices_met`` and ``streams.slices_walked``
take each call's stats: on the CPU at once, on a card once its small copy to
the host has landed, at a later call (none waits for it); a launch counts
under ``k4.launches``.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import numpy as np
import torch

from ..core.constants import MAX_VARINT32_BYTES
from ..utils.profiling import count, trace_annotation
from . import kernels
from .decode_torch import COMP_PAD, parse_all_positions, tag_orbit

SEGMENT = 1 << 16  # a segment closes at the first tag at or past this much output
MAX_SEGMENT = 1 << 17  # the most output a segment may hold
MAX_OFFSET = 0x1FFFF
MAX_LITERAL = 0x1FFF8
STATS = ("rows", "segments", "merged", "whole", "slices", "slices_met", "slices_walked")
SEGMENTED, WHOLE, CORRUPT = 0, -1, -2

# Each card call's stats on their way to the host: (event, pinned int64[1 + len(STATS)]).
_pending: collections.deque = collections.deque()
_pending_lock = threading.Lock()


def check_args(comp, starts, clens, ulens, out_starts, out_len: int) -> int:
    """The stream count n, or raise on arguments of the wrong kind."""
    if comp.dtype != torch.uint8 or comp.dim() != 1 or not comp.is_contiguous():
        raise TypeError(f"comp must be contiguous uint8[N], got {comp.dtype}{list(comp.shape)}")
    n = starts.shape[0] if starts.dim() == 1 else -1
    for name, t, dtype in (("starts", starts, torch.int64), ("clens", clens, torch.int32),
                           ("ulens", ulens, torch.int32), ("out_starts", out_starts, torch.int64)):
        if t.dtype != dtype or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be {dtype}[{n}], got {t.dtype}{list(t.shape)}")
        if t.device != comp.device:
            raise ValueError(f"{name} is on {t.device}, comp on {comp.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_len < 0:
        raise ValueError("out_len must be >= 0")
    return n


def reserve(ulen: int) -> int:
    """Rows a stream of ``ulen`` output bytes reserves: no segment but the
    last holds less than 64 KiB."""
    return -(-ulen // SEGMENT)


def capacity_for(n: int, out_len: int) -> int:
    """Rows enough for n streams whose outputs lie apart in ``out_len``
    bytes: the sum of their reservations is at most this."""
    return n + -(-out_len // SEGMENT)


def segment_streams(comp, starts, clens, ulens, out_starts, out_len: int):
    """Cut n raw streams into K1's ragged rows; see the module docstring."""
    with trace_annotation("k4.segment_streams"):
        n = check_args(comp, starts, clens, ulens, out_starts, out_len)
        capacity = capacity_for(n, out_len)
        if comp.device.type == "cpu":
            rows, ok, stats = segment_streams_plain(comp, starts, clens, ulens, out_starts, out_len, capacity)
            _count(n, stats.tolist())
            return rows, ok, stats
        if comp.device.type != "cuda":
            raise ValueError(f"no stream segmenter for device {comp.device}")
        dev = comp.device
        rows = (torch.empty(capacity, dtype=torch.int64, device=dev), torch.empty(capacity, dtype=torch.int64, device=dev),
                torch.empty(capacity, dtype=torch.int32, device=dev), torch.empty(capacity, dtype=torch.int32, device=dev),
                torch.empty(capacity, dtype=torch.int32, device=dev))
        ok = torch.empty(n, dtype=torch.uint8, device=dev)
        lib = kernels.load("segment_streams")
        ctl_words, pool, summary_bytes = scratch(lib, comp.numel(), n)
        ctl = torch.zeros(ctl_words, dtype=torch.int64, device=dev)
        stats = ctl[: len(STATS)]
        if n:
            sums = torch.empty(pool * summary_bytes, dtype=torch.uint8, device=dev)
            with torch.cuda.device(dev), trace_annotation("k4.launch"):
                rc = lib.snappy_cuda_segment_streams(
                    comp.data_ptr(), comp.numel(), starts.data_ptr(), clens.data_ptr(), ulens.data_ptr(),
                    out_starts.data_ptr(), out_len, n, capacity, *(t.data_ptr() for t in rows), ok.data_ptr(),
                    ctl.data_ptr(), sums.data_ptr(), pool, torch.cuda.current_stream(dev).cuda_stream)
            kernels.check(rc, "segment_streams launch")
            count("k4.launches")
            with torch.cuda.device(dev):
                _queue(n, stats)
        return rows, ok, stats


def scratch(lib, comp_len: int, n: int) -> tuple[int, int, int]:
    """(int64 words of the kernel's zeroed counts and list, summaries, bytes
    a summary) for n streams in ``comp_len`` bytes."""
    ctl, pool, summary = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    lib.snappy_cuda_segment_streams_scratch(comp_len, n, ctypes.byref(ctl), ctypes.byref(pool), ctypes.byref(summary))
    return ctl.value, pool.value, summary.value


def occupancy() -> tuple[int, int]:
    """(bytes of shared memory a block of K4 takes, blocks of it one SM of
    the current card holds at once). Needs a CUDA card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = kernels.load("segment_streams").snappy_cuda_segment_streams_occupancy(ctypes.byref(smem),
                                                                               ctypes.byref(blocks))
    kernels.check(rc, "segment_streams occupancy")
    return smem.value, blocks.value


def _count(n: int, stats) -> None:
    count("streams.streams", n)
    for name, v in zip(STATS[1:], stats[1:]):
        count(f"streams.{name}", int(v))


def _drain() -> None:
    with _pending_lock:
        while _pending and _pending[0][0].query():
            _, host = _pending.popleft()
            _count(int(host[0]), host[1:].tolist())


def _queue(n: int, stats: torch.Tensor) -> None:
    """Fold the stats of the calls whose copies have landed into the
    counters, then send this call's on their way: n and the stats in one
    pinned buffer, behind an event."""
    _drain()
    host = torch.empty(1 + len(STATS), dtype=torch.int64, pin_memory=True)
    host[0] = n
    host[1:].copy_(stats, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    with _pending_lock:
        _pending.append((event, host))


def parse_header(buf: np.ndarray) -> tuple[int, int] | None:
    """(value, length) of the varint32 at the start of ``buf``, or None where
    it is not one: at most 5 bytes, the fifth below 0x10."""
    value = 0
    for k in range(min(MAX_VARINT32_BYTES, len(buf))):
        b = int(buf[k])
        if k == MAX_VARINT32_BYTES - 1 and b >= 0x10:
            return None
        value |= (b & 0x7F) << (7 * k)
        if b < 0x80:
            return value, k + 1
    return None


def _tags(body: torch.Tensor):
    """Every tag the scan walks in ``body`` (uint8[n], on the CPU), in order:
    numpy arrays of (position, is_copy, output length, offset, trailer
    bytes, literal length)."""
    n = body.shape[0]
    padded = torch.nn.functional.pad(body, (0, COMP_PAD))[None, :]
    t = parse_all_positions(padded, 1 << 33)
    nxt = torch.clamp(torch.arange(n) + t["consumed"][0], max=n)
    orbit = tag_orbit(torch.zeros(1, dtype=torch.int64), nxt[None, :], n // 2 + 2)[0]
    pos = orbit[orbit + 1 < n]
    return (pos.numpy(), t["is_copy"][0][pos].numpy(), t["out_len"][0][pos].numpy(), t["offset"][0][pos].numpy(),
            t["taglen"][0][pos].numpy(), t["lit_len"][0][pos].numpy())


def scan_stream(body: torch.Tensor, ulen: int):
    """The native ``scan_blocks`` of one headerless body in plain torch:
    (SEGMENTED, starts, oplens, merged), (WHOLE, ...) where it declines the
    stream, or (CORRUPT, ...). The tags come from the plain decoder's
    successor map; the segment rule is stepped only at the tags where
    something happens (a segment mark, a merge, a limit or a fault)."""
    n = body.shape[0]
    pos, is_copy, out_len, offset, taglen, lit_len = _tags(body)
    ops = np.cumsum(out_len) - out_len  # output before each tag
    tag_end = pos + 1 + taglen
    lit = ~is_copy
    quiet_fault = np.where(is_copy, (offset == 0) | (ops < offset) | (ulen - ops < out_len) | (offset > MAX_OFFSET),
                           (tag_end > n) | (n - tag_end < lit_len) | (ulen - ops < lit_len) | (lit_len > MAX_LITERAL))
    starts: list[int] = []
    oplens: list[int] = []
    blk = seg_start = merged = 0
    cap = ulen // SEGMENT + 1
    i, count_tags = 0, len(pos)
    while i < count_tags:
        rest = slice(i, count_tags)
        event = (quiet_fault[rest] | (ops[rest] - seg_start >= SEGMENT) | (ops[rest] + out_len[rest] - seg_start > MAX_SEGMENT)
                 | (is_copy[rest] & (ops[rest] - offset[rest] < seg_start)))
        if blk == 0:
            event[0] = True
        hits = np.flatnonzero(event)
        if not len(hits):
            break
        j = i + int(hits[0])
        op = int(ops[j])
        if op - seg_start >= SEGMENT or blk == 0:
            if op >= ulen and not (blk == 0 and ulen == 0):
                return CORRUPT, [], [], 0
            if blk == cap:
                return CORRUPT, [], [], 0
            if blk > 0:
                oplens[blk - 1] = op - seg_start
            seg_start = op
            del starts[blk:], oplens[blk:]
            starts.append(int(pos[j]))
            oplens.append(0)
            blk += 1
        length = int(out_len[j])
        if is_copy[j]:
            off = int(offset[j])
            if off == 0 or op < off or ulen - op < length:
                return CORRUPT, [], [], 0
            while op - off < seg_start:
                if blk < 2:
                    return WHOLE, [], [], 0
                blk -= 1
                seg_start -= oplens[blk - 1]
                merged += 1
            if off > MAX_OFFSET:
                return WHOLE, [], [], 0
        else:
            end = int(tag_end[j])
            if end > n or n - end < length or ulen - op < length:
                return CORRUPT, [], [], 0
            if length > MAX_LITERAL:
                return WHOLE, [], [], 0
        if op + length - seg_start > MAX_SEGMENT:
            return WHOLE, [], [], 0
        i = j + 1
    total = int(ops[-1] + out_len[-1]) if count_tags else 0
    if total != ulen:
        return CORRUPT, [], [], 0
    if blk:
        oplens[blk - 1] = total - seg_start
    return SEGMENTED, starts[:blk], oplens[:blk], merged


def segment_streams_plain(comp, starts, clens, ulens, out_starts, out_len: int, capacity: int):
    """The plain version of K4 on CPU tensors, with its table of
    ``capacity`` rows as the kernel takes it: the same rows, reserved in
    stream order."""
    buf = comp.numpy()
    n = starts.shape[0]
    cols = [np.zeros(capacity, np.int64), np.zeros(capacity, np.int64), np.zeros(capacity, np.int32),
            np.zeros(capacity, np.int32), np.zeros(capacity, np.int32)]
    ok = np.zeros(n, np.uint8)
    stats = [0] * len(STATS)
    for s, (start, clen, ulen, out0) in enumerate(zip(starts.tolist(), clens.tolist(), ulens.tolist(),
                                                      out_starts.tolist())):
        fits = 0 <= start <= len(buf) - clen and clen >= 0 and ulen >= 0 and 0 <= out0 <= out_len - ulen
        header = parse_header(buf[start : start + clen]) if fits else None
        if header is None or header[0] != ulen:
            continue
        base, cap = stats[0], reserve(ulen)
        stats[0] += cap
        owned = max(0, min(cap, capacity - base))
        cols[4][base : base + owned] = s
        if owned < cap:
            continue
        body = start + header[1]
        status, seg_in, seg_ulen, merged = scan_stream(torch.from_numpy(buf[body : start + clen].copy()), ulen)
        if status == CORRUPT:
            continue
        ok[s] = 1
        if status == WHOLE:
            seg_in, seg_ulen = [0], [ulen]
            stats[3] += 1
        else:
            stats[2] += merged
        k = len(seg_in)
        seg_in = np.asarray(seg_in, np.int64)
        seg_ulen = np.asarray(seg_ulen, np.int64)
        cols[0][base : base + k] = body + seg_in
        cols[1][base : base + k] = out0 + np.cumsum(seg_ulen) - seg_ulen
        cols[2][base : base + k] = np.diff(np.append(seg_in, clen - header[1]))
        cols[3][base : base + k] = seg_ulen
        stats[1] += k
    rows = tuple(torch.from_numpy(c) for c in cols)
    return rows, torch.from_numpy(ok), torch.tensor(stats, dtype=torch.int64)
