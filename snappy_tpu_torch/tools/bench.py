"""Benchmark harness: the port's codec throughput on the snappy corpus.

    python -m snappy_tpu_torch.tools.bench [--device cuda|cpu] [--report PATH]

The counterpart of the repository's ``bench.py``, with its structure,
names, environment knobs and record keys, on the port's kernels. It prints
one ``{"run": {...}, "stages": [...]}`` line with every stage record and
then, as its last line, the headline::

    {"metric": "device_decompress_throughput", "value": GB/s, "unit": "GB/s/chip",
     "vs_baseline": ..., "vs_target": ..., "vs_r4_same_run": ..., "device": ...}

``vs_baseline`` is over 0.247 GB/s, the Julia reference's large-stream
uncompress rate (BASELINE.md), ``vs_target`` over the build target of 10
GB/s (BASELINE.json), and ``vs_r4_same_run`` (on the card only) is K1's
rate over K3's in the same run. ``--report PATH`` also writes the records,
with the headline under ``run``, as JSON.

Knobs, with bench.py's defaults: ``BENCH_BYTES`` (one batch of ``BATCH``
64 KiB blocks), ``BENCH_FOREIGN`` (1), ``BENCH_WINDOWED`` (1),
``BENCH_LARGE_BYTES`` (64 MiB) and ``BENCH_STREAM_BYTES`` (64 MiB;
676000000 is the reference's large config). As in bench.py, only the first
``BATCH`` blocks of the ``BENCH_BYTES`` corpus stream are encoded and
decoded: a larger ``BENCH_BYTES`` is read and checked to hold one batch,
and no more.

On ``--device cuda`` (bench.py's TPU branch, K1, K2 and K3 in place of the
Pallas kernels):

  ratio_libsnappy   libsnappy's bytes for the batch, where it is installed
  ratio_device      the routed write path on the batch: the detector, K2 on
                    the card for the compressible blocks, the native encoder
                    on the host for the others. Gates, before any timing:
                    every 8th stream decodes under libsnappy and the streams
                    are no larger than its output; where libsnappy is not
                    installed, ``libsnappy_gates`` says they were skipped
  encode            that routed encode timed, the detector and the native
                    encodes inside the timed region, the copy of the card's
                    blocks outside it (host clock around a synchronize)
  decode_own, decode_own_r4control, decode_own_autotuned
                    K1 (key ``r5_farnear``) and K3 (``r4_grouped``) on those
                    streams, gated bit-exact, then in 3 interleaved rounds;
                    the headline is the faster kernel's rate
  decode_foreign    the same A/B, 2 rounds, on ``native.scan_blocks``
                    segments of one native stream of the batch
  decode_windowed_fallback
                    a hostile, unsegmentable 2 MiB stream through
                    ``uncompress(backend="torch")``: one row of K1
  large_device      ``BENCH_LARGE_BYTES`` of distinct batches on the card,
                    encoded by K2 once, then all decoded by K1 and encoded
                    again by K2 back to back, one synchronize each
  stream_large      ``parallel/streaming.py`` on ``BENCH_STREAM_BYTES``, a
                    frame of ``BATCH`` blocks, after one warm-up frame
  scaling_model     ``distributed.decompress_blocks`` with ``gather=True``
                    against ``gather=False`` in turns on one batch: the
                    collective share (``benchmarks/scaling.py``'s measure),
                    over every card, or 4 shards of one card

On ``--device cpu`` (bench.py's branch without a TPU): ratio_libsnappy, the
batch's native (else oracle) streams and the foreign segments decoded by
K1's plain version, the windowed stage and stream_large. There is no encode
stage, no A/B, no large_device and no scaling_model.

Timing: CUDA events on the card (``utils/metrics.device_times``), the host
clock on the CPU; every timed record is ``{min, median, n, spread}``.
``hbm_roofline_frac`` is the least time the card could take for a decode,
its streams' bytes read once and its output written once (with 8 bytes of
lengths and 5 of ``ok`` and total a row, ``chip_smoke.py::bound``'s count)
over the H100's 3.35 TB/s, divided by the time taken; it is null off the
card. A gate that fails raises before any timing, and ``--device cuda``
without a card raises.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..api import uncompress
from ..core import varint
from ..core.config import DEFAULT_MIN_PROFIT
from ..core.constants import BLOCK_SIZE
from ..cpu import oracle
from ..native import libsnappy as ls
from ..native import runtime as nat
from ..ops import cuda_decode, cuda_decode_r4, cuda_encode, kernels, route
from ..ops.decode_torch import COMP_PAD, RAW_WHOLE_LIMIT
from ..ops.encode_torch import BLOCK_MAX_OUT
from ..ops.host import blockify, to_device
from ..parallel import distributed, streaming
from ..utils import profiling
from ..utils.metrics import Metrics, device_times
from .profile_stream import corpus_stream

# The Julia reference's uncompress rate on its 644 MB stream (BASELINE.md).
BASELINE_DECODE_GBPS = 0.247
# The build target (BASELINE.json): >= 10 GB/s/chip decompress.
TARGET_DECODE_GBPS = 10.0
# The H100 SXM's device memory rate (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
BATCH = 128  # blocks a dispatch
B = BLOCK_SIZE
# The decode A/B's kernels, under bench.py's keys: K1 and the pinned K3.
DECODERS = {"r5_farnear": cuda_decode.decode_blocks, "r4_grouped": cuda_decode_r4.decode_blocks}
# K1's, K2's and K3's launch counters, by kernel source.
KERNEL_COUNTERS = {"decode_blocks": "k1.launches", "encode_blocks": "k2.launches", "decode_blocks_r4": "k3.launches"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench gate: {msg}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_name(device: torch.device, kernel: str) -> str:
    return f"cuda {kernel}" if device.type == "cuda" else f"plain {kernel} on {device.type}"


def launches() -> dict[str, int]:
    """Each kernel's launches so far in this process, by kernel source."""
    counts = profiling.counters()
    return {stem: int(counts.get(counter, 0)) for stem, counter in KERNEL_COUNTERS.items()}


def _stats(times: list[float]) -> dict:
    t = sorted(times)
    med = t[len(t) // 2]
    return {"min": t[0], "median": med, "n": len(t), "spread": (t[-1] - t[0]) / med}


def time_dispatch_stats(fn, args, iters: int = 7) -> dict:
    """{min, median, n, spread} seconds of one call ``fn(*args)`` after one
    warm-up call: device time by CUDA events on the card, the host clock on
    the CPU (``utils/metrics.device_times``)."""
    return _stats(device_times(fn, args, iters, warmup=1))


def time_host_stats(fn, device: torch.device, iters: int = 5) -> dict:
    """The same record for work of the host and the card together: the host
    clock around ``fn()`` and a synchronize of ``device``, after one
    warm-up call."""
    fn()
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return _stats(times)


def pack_streams(streams, pad: int):
    cmax = -(-(max(len(s) for s in streams) + pad) // 512) * 512
    comp_np = np.zeros((len(streams), cmax), np.uint8)
    for i, s in enumerate(streams):
        comp_np[i, : len(s)] = np.frombuffer(s, np.uint8) if isinstance(s, bytes) else s
    clens = np.array([len(s) for s in streams], np.int32)
    return cmax, comp_np, clens


def hbm_roofline_frac(seconds: float, comp_bytes: int, rows: int, out_bytes: int, device: torch.device):
    """The least time the H100 could take for a decode of ``rows`` block
    rows (none for a stream) over ``seconds``; None off the card."""
    if device.type != "cuda":
        return None
    return (comp_bytes + 8 * rows + out_bytes + 5 * rows) / HBM_BYTES_PER_S / seconds


def batch_blocks(raw: bytes, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``batch`` 64 KiB blocks of ``raw`` as K2's rows and lengths."""
    check(len(raw) >= batch * B, f"{len(raw)} bytes hold fewer than {batch} blocks")
    return blockify(np.frombuffer(raw, np.uint8)[: batch * B], B)


def libsnappy_stage(raw: bytes, metrics: Metrics, batch: int = BATCH) -> int | None:
    """ratio_libsnappy: libsnappy's headerless bytes for the batch, or None
    where it is not installed."""
    if not ls.available():
        return None
    hdr = len(varint.encode32(B))
    total = sum(len(ls.compress(raw[i * B : (i + 1) * B])) - hdr for i in range(batch))
    metrics.add(stage="ratio_libsnappy", compressed_ratio=total / (batch * B))
    return total


def libsnappy_gates(streams: list[bytes], raw: bytes, ls_total: int | None) -> str:
    """bench.py's gates of the routed streams against libsnappy, or why they
    did not run."""
    if ls_total is None:
        return "skipped: libsnappy not installed"
    for i in range(0, len(streams), 8):
        check(ls.uncompress(varint.encode32(B) + streams[i]) == raw[i * B : (i + 1) * B],
              f"block {i}'s stream does not decode under libsnappy")
    total = sum(len(s) for s in streams)
    check(total <= ls_total, f"routed streams {total} bytes > libsnappy {ls_total}")
    return "ran"


def encode_stage(raw: bytes, device: torch.device, metrics: Metrics, batch: int = BATCH,
                 ls_total: int | None = None) -> list[bytes]:
    """ratio_device and encode (see the module docstring). Returns the
    batch's streams."""
    buf, blens = batch_blocks(raw, batch)
    host_idx = route.host_blocks(buf, blens)
    streams = route.assemble_routed(route.dispatch_routed(buf, blens, host_idx, device, DEFAULT_MIN_PROFIT))
    metrics.add(stage="ratio_device", compressed_ratio=sum(len(s) for s in streams) / (batch * B),
                blocks_host_routed=len(host_idx), libsnappy_gates=libsnappy_gates(streams, raw, ls_total))

    dev_idx = np.setdiff1d(np.arange(batch), host_idx)
    dsub, dsublens = to_device(buf[dev_idx], device), to_device(blens[dev_idx], device)
    sync(device)

    def routed_dispatch():
        route.host_blocks(buf, blens)  # the detector
        if len(dev_idx):
            cuda_encode.encode_blocks(dsub, dsublens, DEFAULT_MIN_PROFIT)  # queued on the card
        route.native_streams_for(buf, blens, host_idx)  # while the card encodes

    st = time_host_stats(routed_dispatch, device)
    metrics.add(stage="encode", gbps_per_chip=batch * B / st["min"] / 1e9,
                gbps_at_median=batch * B / st["median"] / 1e9, seconds_per_batch=st["min"], timing=st,
                kernel=kernel_name(device, "K2") + "+routed_native")
    return streams


def host_streams(raw: bytes, batch: int = BATCH) -> list[bytes]:
    """Headerless streams of the batch's blocks by the native encoder, else
    the oracle: the streams bench.py decodes where there is no device
    encoder."""
    enc = nat.compress if nat.available() else oracle.compress
    out = []
    for i in range(batch):
        s = enc(raw[i * B : (i + 1) * B])
        _, hdr = oracle.uncompressed_length(s)
        out.append(s[hdr:])
    return out


def foreign_streams(raw: bytes, batch: int = BATCH) -> list[bytes]:
    """One native stream of the batch, cut by ``native.scan_blocks`` as the
    raw decode path cuts it; the oracle's block streams without the native
    library."""
    if not nat.available():
        return host_streams(raw, batch)
    stream = nat.compress(raw[: batch * B])
    ulen, hdr = nat.uncompressed_length(stream)
    body = stream[hdr:]
    starts, oplens = nat.scan_blocks(body, ulen)
    check(len(starts) == batch and bool((oplens == B).all()), "the native stream's segments are not its blocks")
    bounds = [int(s) for s in starts] + [len(body)]
    return [body[bounds[i] : bounds[i + 1]] for i in range(batch)]


def decode_args(streams: list[bytes], device: torch.device):
    """(comp, clens, ulens, out_size) of ``streams`` on ``device``, and their
    compressed bytes."""
    _, comp, clens = pack_streams(streams, COMP_PAD)
    ulens = np.full(len(streams), B, np.int32)
    return (to_device(comp, device), to_device(clens, device), to_device(ulens, device), B), int(clens.sum())


def gate_decode(fn, args, expect: bytes, label: str) -> None:
    out, ok, _ = fn(*args)
    check(bool(ok.all()), f"decode flagged corrupt ({label})")
    check(out.cpu().numpy().tobytes() == expect, f"decode mismatch ({label})")


def time_decode(streams: list[bytes], raw: bytes, device: torch.device, label: str, metrics: Metrics) -> float:
    """Gate K1 bit-exact on ``streams``, then time it: bench.py's decode
    stage where there is no TPU. Returns GB/s."""
    args, comp_bytes = decode_args(streams, device)
    nbytes = len(streams) * B
    gate_decode(cuda_decode.decode_blocks, args, raw[:nbytes], label)
    st = time_dispatch_stats(cuda_decode.decode_blocks, args)
    gbps = nbytes / st["min"] / 1e9
    metrics.add(stage=f"decode_{label}", gbps_per_chip=gbps, gbps_at_median=nbytes / st["median"] / 1e9,
                seconds_per_batch=st["min"], timing=st,
                hbm_roofline_frac=hbm_roofline_frac(st["min"], comp_bytes, len(streams), nbytes, device),
                kernel=kernel_name(device, "K1"))
    return gbps


def decode_ab(streams: list[bytes], raw: bytes, device: torch.device, rounds: int, label: str):
    """K1 and K3 on the same streams: both gated bit-exact, then timed in
    ``rounds`` interleaved rounds (min of 3 each). Returns (seconds of each
    round by kernel, GB/s of each kernel's best round, compressed bytes)."""
    args, comp_bytes = decode_args(streams, device)
    nbytes = len(streams) * B
    for name, fn in DECODERS.items():
        gate_decode(fn, args, raw[:nbytes], f"{label}, {name}")
    times = {name: [] for name in DECODERS}
    for _ in range(rounds):
        for name, fn in DECODERS.items():
            times[name].append(time_dispatch_stats(fn, args, iters=3)["min"])
    gbps = {name: nbytes / min(ts) / 1e9 for name, ts in times.items()}
    return times, gbps, comp_bytes


def decode_own_stage(streams: list[bytes], raw: bytes, device: torch.device, metrics: Metrics) -> tuple[float, float]:
    """decode_own, decode_own_r4control and decode_own_autotuned (3
    rounds). Returns the picked kernel's GB/s and vs_r4_same_run."""
    times, gbps, comp_bytes = decode_ab(streams, raw, device, 3, "own")
    rounds_ms = {name: [t * 1e3 for t in ts] for name, ts in times.items()}
    vs_r4 = gbps["r5_farnear"] / gbps["r4_grouped"]
    k1_s = min(times["r5_farnear"])
    metrics.add(stage="decode_own", gbps_per_chip=gbps["r5_farnear"], seconds_per_batch=k1_s, rounds_ms=rounds_ms,
                hbm_roofline_frac=hbm_roofline_frac(k1_s, comp_bytes, len(streams), len(streams) * B, device),
                kernel=kernel_name(device, "K1"))
    metrics.add(stage="decode_own_r4control", gbps_per_chip=gbps["r4_grouped"],
                seconds_per_batch=min(times["r4_grouped"]), vs_r4_same_run=vs_r4, kernel=kernel_name(device, "K3"))
    picked = max(gbps, key=gbps.get)
    metrics.add(stage="decode_own_autotuned", gbps_per_chip=gbps[picked], picked=picked)
    return gbps[picked], vs_r4


def decode_foreign_stage(streams: list[bytes], raw: bytes, device: torch.device, metrics: Metrics) -> None:
    """decode_foreign: the A/B in 2 rounds on foreign streams."""
    times, gbps, comp_bytes = decode_ab(streams, raw, device, 2, "foreign")
    picked = max(gbps, key=gbps.get)
    metrics.add(stage="decode_foreign", gbps_per_chip=gbps[picked], picked=picked, per_kernel_gbps=gbps,
                rounds_ms={name: [t * 1e3 for t in ts] for name, ts in times.items()},
                hbm_roofline_frac=hbm_roofline_frac(min(times[picked]), comp_bytes, len(streams), len(streams) * B,
                                                    device),
                kernel=kernel_name(device, "K1/K3") + " (autotuned)")


def hostile_stream(target: int) -> tuple[bytes, bytes]:
    """bench.py's hostile but valid stream of about ``target`` output bytes,
    and the bytes it decodes to: one literal of 200,000 bytes, then COPY_4s
    of 64 bytes at offset 150,000. No segmenter can cut it (every copy
    reaches back past any 64 KiB boundary)."""
    big_lit = np.frombuffer(corpus_stream(200_000), np.uint8)
    ncopies = (target - len(big_lit)) // 64
    out_len = len(big_lit) + 64 * ncopies
    stream = (
        varint.encode32(out_len)
        + bytes([62 << 2]) + (len(big_lit) - 1).to_bytes(3, "little") + big_lit.tobytes()
        + (bytes([(63 << 2) | 3]) + (150_000).to_bytes(4, "little")) * ncopies
    )
    # Every copy reads 150,000 bytes back, so the output repeats with that
    # period past the literal.
    exp = np.empty(out_len, np.uint8)
    exp[: len(big_lit)] = big_lit
    for o in range(len(big_lit), out_len, 150_000):
        n = min(150_000, out_len - o)
        exp[o : o + n] = exp[o - 150_000 : o - 150_000 + n]
    return stream, exp.tobytes()


def windowed_stage(device: torch.device, metrics: Metrics, target: int = 2 << 20) -> None:
    """decode_windowed_fallback: the hostile stream through
    ``uncompress(backend="torch")`` on ``device``, one call."""
    stream, expect = hostile_stream(target)
    ulen, hdr = varint.parse32(np.frombuffer(stream, np.uint8), 0)
    if nat.available():
        check(nat.scan_blocks(stream[hdr:], ulen) is None, "the hostile stream was segmented")
    if device.type == "cuda":
        decoder = "cuda K1, one row"
    elif len(stream) - hdr > RAW_WHOLE_LIMIT:
        decoder = "decode_torch.decode_raw_windowed"
    else:
        decoder = "plain K1 (decode_torch.decode_blocks), one row"
    before = launches()
    t0 = time.perf_counter()
    out = uncompress(stream, backend="torch", device=device)
    t = time.perf_counter() - t0
    check(out == expect, "windowed fallback mismatch")
    check(device.type != "cuda" or launches()["decode_blocks"] == before["decode_blocks"] + 1,
          "the hostile stream was not one launch of K1")
    metrics.add(stage="decode_windowed_fallback", bytes=len(expect), gbps=len(expect) / t / 1e9, decoder=decoder,
                note="hostile valid stream (unsegmentable) through uncompress(backend='torch'): one row, "
                "host clock around the whole call")


def large_device_stage(device: torch.device, metrics: Metrics, large_bytes: int = 64 << 20,
                       batch: int = BATCH) -> None:
    """large_device: distinct batches covering ``large_bytes`` resident on
    the card, encoded by K2 once and gated through K1, then every batch
    decoded by K1 back to back and encoded again by K2 back to back, each
    run timed with one synchronize."""
    loops = -(-large_bytes // (batch * B))
    lraw = corpus_stream(loops * batch * B)
    lens = to_device(np.full(batch, B, np.int32), device)
    bufs, comps, clens = [], [], []
    for k in range(loops):
        buf, _ = batch_blocks(lraw[k * batch * B : (k + 1) * batch * B], batch)
        bufs.append(to_device(buf, device))
        out, olens = cuda_encode.encode_blocks(bufs[-1], lens, DEFAULT_MIN_PROFIT)
        comps.append(out)
        clens.append(olens)
    all_clens = torch.cat(clens).cpu()
    check(int(all_clens.min()) >= 0 and int(all_clens.max()) + COMP_PAD <= BLOCK_MAX_OUT,
          "a K2 stream does not fit K1's row")
    for k in range(loops):
        gate_decode(cuda_decode.decode_blocks, (comps[k], clens[k], lens, B),
                    lraw[k * batch * B : (k + 1) * batch * B], f"large_device batch {k}")
    sync(device)
    t0 = time.perf_counter()
    for k in range(loops):
        cuda_decode.decode_blocks(comps[k], clens[k], lens, B)
    sync(device)
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(loops):
        cuda_encode.encode_blocks(bufs[k], lens, DEFAULT_MIN_PROFIT)
    sync(device)
    t_enc = time.perf_counter() - t0
    nbytes = loops * batch * B
    metrics.add(stage="large_device", bytes=nbytes, compress_gbps=nbytes / t_enc / 1e9,
                uncompress_gbps=nbytes / t_dec / 1e9,
                uncompress_roofline_frac=hbm_roofline_frac(t_dec, int(all_clens.sum()), loops * batch, nbytes, device),
                note="device-resident kernel rate over distinct batches resident on the device, covering the "
                "full byte count (host copies excluded)")


def stream_stage(device: torch.device, metrics: Metrics, stream_bytes: int = 64 << 20, batch: int = BATCH) -> None:
    """stream_large: the streaming pipeline on ``stream_bytes`` of the corpus
    mix in frames of ``batch`` blocks, each direction timed on the host
    clock after one warm-up frame, the round trip gated."""
    sraw = corpus_stream(stream_bytes)
    warm = io.BytesIO()
    streaming.compress_stream(io.BytesIO(sraw[: batch * B]), warm, device=device, blocks_per_frame=batch)
    warm.seek(0)
    streaming.uncompress_stream(warm, io.BytesIO(), device=device)
    comp = io.BytesIO()
    t0 = time.perf_counter()
    csize = streaming.compress_stream(io.BytesIO(sraw), comp, device=device, blocks_per_frame=batch)
    t_c = time.perf_counter() - t0
    comp.seek(0)
    out = io.BytesIO()
    t0 = time.perf_counter()
    n = streaming.uncompress_stream(comp, out, device=device)
    t_u = time.perf_counter() - t0
    check(n == len(sraw) and out.getvalue() == sraw, "streaming round-trip mismatch")
    metrics.add(stage="stream_large", bytes=len(sraw), ratio=csize / len(sraw), compress_gbps=len(sraw) / t_c / 1e9,
                uncompress_gbps=len(sraw) / t_u / 1e9,
                uncompress_roofline_frac=hbm_roofline_frac(t_u, csize, 0, len(sraw), device), blocks_per_frame=batch,
                retries=streaming.last_stats.get("retries", 0))


def scaling_stage(device: torch.device, metrics: Metrics, batch: int = BATCH, rounds: int = 10) -> None:
    """scaling_model: ``distributed.decompress_blocks`` of one batch of K2
    streams with ``gather=True`` against ``gather=False``, ``rounds``
    interleaved rounds of min-of-3 calls each (host clock around a
    synchronize of every shard's device), as benchmarks/scaling.py measures
    the collective share: 1 - median(no gather) / median(gather), floored
    at 0. The mesh is every card where there are several, else 4 shards of
    ``device``."""
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if n_cards > 1:
        devices = [torch.device("cuda", i) for i in range(n_cards)]
        shards = f"{n_cards} cards: " + ", ".join(torch.cuda.get_device_name(i) for i in range(n_cards))
    else:
        devices = [device] * 4
        shards = "4 of one card" if device.type == "cuda" else f"4 of one {device.type}"
    mesh = distributed.mesh_1d(devices)
    raw = corpus_stream(batch * B)
    nb = distributed.pad_block_count(batch, mesh.size)
    buf, blens = blockify(np.frombuffer(raw, np.uint8), B, nb)
    outs, olens = distributed.compress_blocks(buf, blens, mesh, gather=True)
    enc = outs[0].cpu().numpy()
    clens = olens[0].cpu().numpy()
    comp = np.zeros((nb, enc.shape[1] + 64), np.uint8)  # room for COMP_PAD past the longest stream
    comp[:, : enc.shape[1]] = enc

    def run(gather: bool):
        res = distributed.decompress_blocks(comp, clens, blens, mesh, B, gather=gather)
        for d in set(devices):
            sync(d)
        return res

    for gather in (False, True):
        douts, oks, _ = run(gather)
        ok = torch.cat([o.cpu() for o in oks]) if not gather else oks[0].cpu()
        out = torch.cat([o.cpu() for o in douts]) if not gather else douts[0].cpu()
        check(bool(ok.all()) and out.numpy()[:batch].tobytes() == raw, f"sharded decode, gather={gather}")
    med_rounds = {"nogather": [], "gather": []}
    for _ in range(rounds):
        for gather in (False, True):
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(gather)
                ts.append(time.perf_counter() - t0)
            med_rounds["gather" if gather else "nogather"].append(min(ts))
    med = {k: sorted(v)[len(v) // 2] for k, v in med_rounds.items()}
    share_raw = 1.0 - med["nogather"] / med["gather"]
    share = max(0.0, share_raw)
    metrics.add(stage="scaling_model", collective_share=share, collective_share_raw=share_raw,
                model_scaling_efficiency=1.0 - share, nogather_s=med["nogather"], gather_s=med["gather"],
                rounds_spread={k: (max(v) - min(v)) / med[k] for k, v in med_rounds.items()}, rounds=rounds,
                blocks=batch, shards=shards,
                source="measured: distributed.decompress_blocks gather=True against gather=False, in turns")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def bench(device, bench_bytes: int, foreign: bool = True, windowed: bool = True, large_bytes: int = 64 << 20,
          stream_bytes: int = 64 << 20, batch: int = BATCH) -> tuple[Metrics, dict]:
    """Run every stage of ``device``'s branch. Returns the records and the
    headline line."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("bench: --device cuda, but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        kernels.load(*KERNEL_COUNTERS)  # one nvcc a source, all at once
    elif device.type != "cpu":
        raise ValueError(f"bench: no codec for device {device}")
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    metrics = Metrics(run={"device": name, "platform": "gpu" if on_card else "cpu", "batch": batch})
    if on_card:
        metrics.run["card"] = card_line()
    before = launches()

    raw = corpus_stream(bench_bytes)
    check(len(raw) // B >= batch, "BENCH_BYTES too small for one batch")
    ls_total = libsnappy_stage(raw, metrics, batch)
    vs_r4 = None
    if on_card:
        streams = encode_stage(raw, device, metrics, batch, ls_total)
        dec_gbps, vs_r4 = decode_own_stage(streams, raw, device, metrics)
    else:
        dec_gbps = time_decode(host_streams(raw, batch), raw, device, "own", metrics)
    if foreign:
        fstreams = foreign_streams(raw, batch)
        if on_card:
            decode_foreign_stage(fstreams, raw, device, metrics)
        else:
            time_decode(fstreams, raw, device, "foreign", metrics)
    if windowed:
        windowed_stage(device, metrics)
    if on_card and large_bytes > 0:
        large_device_stage(device, metrics, large_bytes, batch)
    if stream_bytes > 0:
        stream_stage(device, metrics, stream_bytes, batch)
    if on_card:
        scaling_stage(device, metrics, batch)
    metrics.run["launches"] = {k: n - before[k] for k, n in launches().items()}

    line = {
        "metric": "device_decompress_throughput",
        "value": dec_gbps,
        "unit": "GB/s/chip",
        "vs_baseline": dec_gbps / BASELINE_DECODE_GBPS,
        "vs_target": dec_gbps / TARGET_DECODE_GBPS,
    }
    if vs_r4 is not None:
        line["vs_r4_same_run"] = vs_r4
    line["device"] = name
    return metrics, line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", default=None, help="also write the records and the headline to this JSON file")
    args = p.parse_args(argv)
    env = os.environ
    metrics, line = bench(
        args.device,
        bench_bytes=int(env.get("BENCH_BYTES", BATCH * B)),
        foreign=env.get("BENCH_FOREIGN", "1") != "0",
        windowed=env.get("BENCH_WINDOWED", "1") != "0",
        large_bytes=int(env.get("BENCH_LARGE_BYTES", 64 << 20)),
        stream_bytes=int(env.get("BENCH_STREAM_BYTES", 64 << 20)),
        batch=BATCH,
    )
    print(json.dumps({"run": metrics.run, "stages": metrics.results}), flush=True)
    if args.report:
        metrics.run["headline"] = line
        metrics.dump(args.report)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
