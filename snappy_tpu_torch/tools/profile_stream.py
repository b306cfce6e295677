"""Where the streaming pipeline's time goes, on one device.

    python -m snappy_tpu_torch.tools.profile_stream [--bytes N] [--blocks-per-frame B] [--device DEV]

Codes N bytes of the corpus mix (``chip_smoke.py``'s, in bench.py's order;
default 676,000,000, the reference's large config) through
``compress_stream`` and ``uncompress_stream`` on ``io.BytesIO``, and the
same frames one at a time through ``compress_framed`` and
``uncompress_framed``, in turns: pipelined, one at a time, one at a time,
pipelined, after one warm-up frame. Every run must give the bytes of the
first.

Each call of ``parallel/host.py``'s dispatch and assemble functions, and of
the stages inside them, is timed on the host clock: for encode the routing
detector (``route.host_blocks``), the staged copy to the device
(``route.stage``), the kernel's launch and the routed blocks' host encode;
for decode the staged copy of the payload and lengths (``ops.host.stage``),
the rows' packing on the device (``ops.host.rows_from_span``), the launch
and the crc check (``framed.verify_crcs``). What dispatch holds beyond its
stages is cutting blocks, queuing the results' copy back and taking crcs
(encode) or parsing the index (decode). On a CUDA device the wait of each
assemble for its own frame's results (``ops.host.HostCopy.wait``, the
frame's event) is timed apart: the time the host stands idle for the card
while the frames queued after it run on. A decode's assemble is
``host.assemble_uncompress_array``, which a stream writes out as it is;
one frame at a time, ``uncompress_framed`` joins it into bytes after it.
What the wall time holds beyond dispatch and assemble is reading and
writing the streams (the pipeline's ``read`` and ``write`` spans), or that
join.

Then two one-off measures. How an encoded frame's results should come
back (``fetch_choice``): whole rows into pinned memory behind an event, as
``route.dispatch_routed`` queues them, against the lengths first and then
only each row's bytes, which needs two host waits. And the card's busy
share of one pipelined decode of the whole sequence (``busy_share``): the
union of the kernels and copies in a ``utils.profiling.profile_to`` trace
over the host's wall time inside it. The card's name and power limit come
first, one line a run, a line each for the two measures, and a
``{"profile_stream": [...], "fetch": {...}, "busy": {...}}`` line last.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .. import parallel
from ..core.config import DEFAULT_MIN_PROFIT
from ..ops import host as ohost
from ..ops import route
from ..parallel import framed, streaming
from ..parallel import host as phost
from ..utils.profiling import profile_to

BLOCK = 1 << 16
REPO = Path(__file__).resolve().parents[2]
# chip_smoke.py's corpus mix, in bench.py's order.
MIX = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]
LARGE_CONFIG_BYTES = 676_000_000


def corpus_stream(target: int) -> bytes:
    """``target`` bytes of the corpus files in turn."""
    bufs = [(REPO / "testdata" / n).read_bytes() for n in MIX]
    out, total, i = [], 0, 0
    while total < target:
        out.append(bufs[i % len(bufs)])
        total += len(out[-1])
        i += 1
    return b"".join(out)[:target]


@contextlib.contextmanager
def timed_stages(device, spans: dict):
    """Time every call of the dispatch and assemble functions and their
    stages into ``spans`` (seconds by name) while the block is open."""
    targets = [  # (module, function, span)
        (phost, "dispatch_compress", "dispatch_compress"),
        (route, "host_blocks", "dispatch_compress.route_detect"),
        (route, "stage", "dispatch_compress.copy_in"),
        (route, "block_encoder", "dispatch_compress.launch"),
        (route, "native_streams_for", "dispatch_compress.native_encode"),
        (phost, "assemble_compress", "assemble_compress"),
        (phost, "dispatch_uncompress", "dispatch_uncompress"),
        (ohost, "stage", "dispatch_uncompress.copy_in"),
        (ohost, "rows_from_span", "dispatch_uncompress.pack"),
        (phost, "block_decoder", "dispatch_uncompress.launch"),
        (phost, "assemble_uncompress_array", "assemble_uncompress"),
        (framed, "verify_crcs", "assemble_uncompress.crc"),
    ]
    if torch.device(device).type == "cuda":
        # A CPU tensor's HostCopy has no event and waits for nothing.
        targets.append((ohost.HostCopy, "wait", "wait"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    active = []  # the timed calls open now, innermost last

    def timing(span, fn):
        def run(*args, **kw):
            # A wait counts under the assemble that waits.
            name = f"{active[-1]}.wait" if span == "wait" and active else span
            active.append(name)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans[name] += time.perf_counter() - t0
                active.pop()

        return run

    def timing_launch(span, select):
        # block_encoder and block_decoder return the wrapper that launches.
        return lambda device, *a: timing(span, select(device, *a))

    try:
        for mod, name, span in targets:
            fn = getattr(mod, name)
            setattr(mod, name, timing_launch(span, fn) if name.startswith("block_") else timing(span, fn))
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class TimedIO(io.BytesIO):
    """A BytesIO whose reads and writes add their host time to ``spans``
    (``read``, ``write``): the pipeline's I/O, inside the rest of its wall
    time."""

    def __init__(self, spans: dict, initial: bytes = b""):
        super().__init__(initial)
        self.spans = spans

    def read(self, *args):
        t0 = time.perf_counter()
        try:
            return super().read(*args)
        finally:
            self.spans["read"] += time.perf_counter() - t0

    def write(self, b):
        t0 = time.perf_counter()
        try:
            return super().write(b)
        finally:
            self.spans["write"] += time.perf_counter() - t0


def profile(raw: bytes, blocks_per_frame: int, device) -> list[dict]:
    """The four turns of each direction over ``raw``: one record a run."""
    chunk = blocks_per_frame * BLOCK
    chunks = [raw[i : i + chunk] for i in range(0, len(raw), chunk)]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def pipelined_compress(spans):
        dst = TimedIO(spans)
        streaming.compress_stream(TimedIO(spans, raw), dst, device=device, blocks_per_frame=blocks_per_frame)
        return dst

    def serial_compress():
        return [parallel.compress_framed(c, device=device) for c in chunks]

    def pipelined_uncompress(comp, spans):
        dst = TimedIO(spans)
        streaming.uncompress_stream(TimedIO(spans, comp), dst, device=device)
        return dst

    def serial_uncompress(frames):
        return [parallel.uncompress_framed(f, device=device) for f in frames]

    warm = io.BytesIO()
    streaming.compress_stream(io.BytesIO(chunks[0]), warm, device=device, blocks_per_frame=blocks_per_frame)
    streaming.uncompress_stream(io.BytesIO(warm.getvalue()), io.BytesIO(), device=device)

    records, comp, frames = [], None, None
    for mode in ("pipelined", "serial", "serial", "pipelined"):
        for direction in ("compress", "uncompress"):
            spans: dict = defaultdict(float)
            sync()
            with timed_stages(device, spans):
                t0 = time.perf_counter()
                if direction == "compress":
                    got = pipelined_compress(spans) if mode == "pipelined" else serial_compress()
                else:
                    got = pipelined_uncompress(comp, spans) if mode == "pipelined" else serial_uncompress(frames)
                wall = time.perf_counter() - t0
            got = got.getvalue() if mode == "pipelined" else b"".join(got)
            if direction == "compress":
                if comp is None:
                    comp = got
                    frames = list(streaming.iter_frames(io.BytesIO(comp)))
                if got != comp:
                    raise RuntimeError(f"{mode} compress gave other bytes than the first run")
            elif got != raw:
                raise RuntimeError(f"{mode} uncompress is not bit-exact")
            dispatch = spans[f"dispatch_{direction}"]
            assemble = spans[f"assemble_{direction}"]
            records.append({
                "mode": mode,
                "direction": direction,
                "bytes": len(raw),
                "frames": len(chunks),
                "seconds": wall,
                "gbps": len(raw) / wall / 1e9,
                "spans": dict(spans),
                "io_and_rest": wall - dispatch - assemble,
            })
    return records


def fetch_choice(raw: bytes, blocks_per_frame: int, device, turns: int = 5) -> dict:
    """The first frame of ``raw``'s device rows through the block encoder,
    then its results to the host in turns: ``whole_rows``, a ``HostCopy``
    of (out, olens); ``lengths_first``, olens, then the bytes that the
    lengths keep, picked on the device. Median host ms from a synchronised
    start, and the bytes each moves."""
    buf, blens = ohost.blockify(np.frombuffer(raw[: blocks_per_frame * BLOCK], np.uint8), BLOCK)
    dev_idx = np.setdiff1d(np.arange(len(blens)), route.host_blocks(buf, blens))
    out, olens = route.block_encoder(device)(*ohost.stage([buf[dev_idx], blens[dev_idx]], device), DEFAULT_MIN_PROFIT)
    cuda = torch.device(device).type == "cuda"

    def whole_rows():
        return ohost.HostCopy([out, olens]).wait()[0].nbytes

    def lengths_first():
        lens = olens.cpu()
        keep = torch.arange(out.shape[1], device=out.device)[None, :] < olens[:, None]
        return lens.numpy().nbytes + out[keep].cpu().numpy().nbytes

    ms: dict = {"whole_rows": [], "lengths_first": []}
    moved = {}
    for _ in range(turns):
        for name, fn in (("whole_rows", whole_rows), ("lengths_first", lengths_first)):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved[name] = fn()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {"rows": len(dev_idx), **{f"{k}_ms": statistics.median(v) for k, v in ms.items()},
            **{f"{k}_bytes": v for k, v in moved.items()}}


# Trace events of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_share(comp: bytes, device, logdir: str) -> dict:
    """One ``uncompress_stream`` of the frame sequence ``comp`` under
    ``profile_to`` into ``logdir``: the host's wall time inside the trace,
    the union of the card's kernels and copies in it, and their share."""
    with profile_to(logdir):
        t0 = time.perf_counter()
        streaming.uncompress_stream(io.BytesIO(comp), io.BytesIO(), device=device)
        wall = time.perf_counter() - t0
    newest = max(Path(logdir).iterdir(), key=os.path.getmtime)
    events = [e for e in json.loads(newest.read_text())["traceEvents"] if e.get("cat") in DEVICE_CATS]
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {"seconds": wall, "device_busy_s": busy_us / 1e6, "busy_share": busy_us / 1e6 / wall,
            "kernels": sum(e["cat"] == "kernel" for e in events), "copies": sum(e["cat"] != "kernel" for e in events)}


def line(r: dict) -> str:
    spans = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(r["spans"].items()))
    return (f"{r['direction']:10s} {r['mode']:9s} {r['seconds']:.4f} s ({r['gbps']:.4f} GB/s), "
            f"{r['frames']} frames; ms: {spans}; reads, writes and the rest {r['io_and_rest'] * 1e3:.1f}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_stream", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bytes", type=int, default=LARGE_CONFIG_BYTES)
    p.add_argument("--blocks-per-frame", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    else:
        print(f"device {args.device} (no card: host times only)", flush=True)
    raw = corpus_stream(args.bytes)
    records = profile(raw, args.blocks_per_frame, args.device)
    for r in records:
        print(line(r), flush=True)
    fetch = fetch_choice(raw, args.blocks_per_frame, args.device)
    print(f"encoded frame's results back, {fetch['rows']} rows: whole rows {fetch['whole_rows_ms']:.3f} ms "
          f"({fetch['whole_rows_bytes']} bytes), lengths first {fetch['lengths_first_ms']:.3f} ms "
          f"({fetch['lengths_first_bytes']} bytes)", flush=True)
    comp = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), comp, device=args.device, blocks_per_frame=args.blocks_per_frame)
    with tempfile.TemporaryDirectory() as tmp:
        busy = busy_share(comp.getvalue(), args.device, tmp)
    print(f"uncompress_stream under profile_to: {busy['seconds']:.4f} s, the card busy {busy['device_busy_s']:.4f} s "
          f"({busy['busy_share']:.4f}; {busy['kernels']} kernels, {busy['copies']} copies)", flush=True)
    print(json.dumps({"profile_stream": records, "fetch": fetch, "busy": busy}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
