"""Content-routed block encoding: incompressible blocks bypass the device.

The counterpart of ``snappy_tpu/ops/route.py``, giving the same routing
decisions. A host detector samples each block's 4-byte grams and measures
their duplicate ratio; blocks below ``DUP_THRESHOLD`` (jpeg, the image
streams of a pdf) are compressed on the host by the native C++ greedy
encoder, and the rest go to the block encoder on the device. The device
launch is queued first, so the host encoders run while the kernel does.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from ..native import runtime as nat
from ..utils.profiling import trace_annotation
from .host import to_device
from .select import block_encoder

#: sampled-gram duplicate ratio below which a block is treated as
#: incompressible
DUP_THRESHOLD = 0.05


def _grams(buf: np.ndarray, rows: np.ndarray, n: int) -> np.ndarray:
    """Little-endian 4-byte grams of ``buf[rows]`` (a C-contiguous uint8
    batch) at every ``max(1, n >> 11)``-th column below n, as
    uint32[len(rows), samples]. The four bytes of a sample are read
    together, and nothing but the samples is read."""
    step = max(1, n >> 11)
    buf = np.ascontiguousarray(buf)
    view = np.lib.stride_tricks.as_strided(
        buf, (len(buf), len(range(0, n, step)), 4), (buf.strides[0], step, 1), writeable=False
    )
    return view[rows].view("<u4")[..., 0].astype(np.uint32, copy=False)


def dup_ratios(buf: np.ndarray, blens: np.ndarray, n_blocks: int) -> np.ndarray:
    """Sampled 4-gram duplicate ratio of the first ``n_blocks`` rows.

    Blocks of the batch's most common length (at least 1 KiB) are scored
    together as the share of equal neighbours among their sorted samples;
    any other block of at least 1 KiB as one minus its share of distinct
    samples, as the reference does, so that a block's score depends on the
    batch it is in. Blocks under 1 KiB score 1 and never route.
    """
    out = np.ones(n_blocks, np.float32)
    lens = blens[:n_blocks].astype(np.int64)
    big = lens >= 1024
    if not big.any():
        return out
    vals, counts = np.unique(lens[big], return_counts=True)
    modal = int(vals[np.argmax(counts)])
    uniform = np.flatnonzero(big & (lens == modal))
    w = _grams(buf, uniform, modal - 3)
    w.sort(axis=1)
    out[uniform] = (w[:, 1:] == w[:, :-1]).mean(axis=1, dtype=np.float32)
    for i in np.flatnonzero(big & (lens != modal)):
        w = _grams(buf, np.array([i]), int(lens[i]) - 3)
        out[i] = 1.0 - len(np.unique(w)) / w.size
    return out


def host_blocks(buf: np.ndarray, blens: np.ndarray) -> np.ndarray:
    """Indices of the blocks of the batch to compress on the host: none
    where the native encoder cannot load, as in the reference."""
    if not nat.available():
        return np.zeros(0, np.int64)
    return np.flatnonzero(dup_ratios(buf, blens, len(blens)) < DUP_THRESHOLD)


def native_streams_for(buf: np.ndarray, blens: np.ndarray, host_idx) -> dict[int, bytes]:
    """Tag streams of the rows ``host_idx``, by the native greedy encoder:
    one batched call per worker thread, the threads splitting the rows (the
    call releases the GIL, so the encoders run on all cores)."""
    idx = [int(i) for i in host_idx]
    if not idx:
        return {}
    workers = min(os.cpu_count() or 1, 8, len(idx))
    chunks = [idx[k::workers] for k in range(workers)]
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        outs = list(pool.map(lambda c: nat.compress_rows(buf, blens, c), chunks))
    streams = {}
    for c, s in zip(chunks, outs):
        streams.update(zip(c, s))
    return streams


def dispatch_routed(buf: np.ndarray, blens: np.ndarray, host_idx, device, min_profit: int, encoder: str = "kernel"):
    """Queue the encode of the blocks (buf, blens): the rows of
    ``host_idx`` on the host, the others with the block encoder
    ``encoder`` (``select.ENCODERS``) on ``device``. The device launch is
    queued before the host encoders run. Returns a ticket for
    :func:`assemble_routed`."""
    encode = block_encoder(device, encoder)
    n_blocks = len(blens)
    dev_idx = np.setdiff1d(np.arange(n_blocks), host_idx)
    dev = None
    if len(dev_idx):
        with trace_annotation("route.dispatch_device"):
            # The whole batch goes over in one copy and the device rows are
            # picked there: cheaper than a gather of them on the host.
            blocks, lens = to_device(buf, device), to_device(blens, device)
            if len(dev_idx) < n_blocks:
                pick = to_device(dev_idx, device)
                blocks, lens = blocks[pick], lens[pick]
            dev = encode(blocks, lens, min_profit)
    with trace_annotation("route.native_streams"):
        native = native_streams_for(buf, blens, host_idx)
    return dev, dev_idx, native, n_blocks


def device_streams(out: torch.Tensor, olens: torch.Tensor) -> list[bytes]:
    """Wait for the block encoder's (out, olens) and return each row's tag
    stream. Only each row's first ``olens`` bytes are copied back."""
    lens = olens.cpu().numpy().astype(np.int64)
    if (lens < 0).any():
        raise RuntimeError("the block encoder refused a row it was given")
    keep = torch.arange(out.shape[1], device=out.device)[None, :] < olens[:, None]
    flat = out[keep].cpu().numpy()
    ends = np.cumsum(lens)
    return [flat[e - n : e].tobytes() for e, n in zip(ends.tolist(), lens.tolist())]


def assemble_routed(ticket) -> list[bytes]:
    """Wait for the device part and return the tag streams in block order."""
    dev, dev_idx, native, n_blocks = ticket
    streams: list[bytes] = [b""] * n_blocks
    if dev is not None:
        with trace_annotation("route.assemble_device"):
            for i, s in zip(dev_idx.tolist(), device_streams(*dev)):
                streams[i] = s
    for i, s in native.items():
        streams[i] = s
    return streams
