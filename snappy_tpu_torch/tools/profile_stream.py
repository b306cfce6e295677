"""Where the streaming pipeline's time goes, on one device.

    python -m snappy_tpu_torch.tools.profile_stream [--bytes N] [--blocks-per-frame B] [--device DEV]

Codes N bytes of the corpus mix (``chip_smoke.py``'s, in bench.py's order;
default 676,000,000, the reference's large config) through
``compress_stream`` and ``uncompress_stream`` on ``io.BytesIO``, and the
same frames one at a time through ``compress_framed`` and
``uncompress_framed``, in turns: pipelined, one at a time, one at a time,
pipelined, after one warm-up frame. Every run must give the bytes of the
first.

The stages are the program's own spans (``utils/profiling.py``), recorded
under ``profiling.recording()``; each is printed as its self time summed
over the run, under the name of the dispatch or assemble call it lies in
(``parallel/host.py``): for encode the routing detector
(``dispatch_compress.route_detect``), the staged copy to the device
(``.copy_in``), the kernel's wrapper (``.launch``), the routed blocks' host
encode (``.native_encode``) and the crcs (``.crc``); for decode the index
(``dispatch_uncompress.framed.parse``), the staged copy of the payload and
lengths (``.copy_in``), the rows' packing on the device (``.pack``), the
kernel's wrapper (``.launch``), the crc check (``assemble_uncompress.crc``)
and the rows joined (``.framed.join``). A span with no name of its own here
keeps the program's (``dispatch_uncompress.k1.launch``: the launch itself).
``dispatch_<direction>`` and ``assemble_<direction>`` are what those calls
hold beyond their stages. On a CUDA device the wait of each assemble for its
own frame's results (``host.wait``, the frame's event) is its ``.wait``: the
time the host stands idle for the card while the frames queued after it run
on. A decode's assemble is ``host.assemble_uncompress_array``, which a
stream writes out as it is; one frame at a time, ``uncompress_framed``
joins it into bytes after it (``framed.join``). What the wall time holds
beyond dispatch and assemble is reading and writing the streams (the
pipeline's ``read`` and ``write``), or that join. Each run also gives the
counters it moved: blocks routed to the host and left on the card, bytes
staged, bytes whose crc was taken, and spans dropped past the registry's
bound (a nonzero count means the stages miss time). A line gives the kernel loader's
spans (``kernels.load``, its nvcc ``kernels.build``) in the process.

Then two one-off measures. How an encoded frame's results should come
back (``fetch_choice``): whole rows into pinned memory behind an event, as
``route.dispatch_routed`` queues them, against the lengths first and then
only each row's bytes, which needs two host waits. And the card's busy
share of one pipelined decode of the whole sequence (``busy_share``): the
union of the kernels and copies in a ``utils.profiling.profile_to`` trace
over the host's wall time inside it. The card's name and power limit come
first, one line a run, the loader's line, a line each for the two measures,
and a ``{"profile_stream": [...], "loader": {...}, "fetch": {...},
"busy": {...}}`` line last.
"""

from __future__ import annotations

import argparse
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
from ..parallel import streaming
from ..utils import profiling
from ..utils.profiling import profile_to
from .corpus import BLOCK, corpus_stream

LARGE_CONFIG_BYTES = 676_000_000


# The names the stages are printed under, by span: a top-level call (the
# outermost span of its request), and a stage beneath one, printed as
# "<call>.<stage>"; any other span keeps its own name.
TOP = {
    "framed.dispatch_compress": "dispatch_compress",
    "framed.assemble_compress": "assemble_compress",
    "framed.dispatch_uncompress": "dispatch_uncompress",
    "framed.assemble_uncompress": "assemble_uncompress",
    "stream.read": "read",
    "stream.write": "write",
}
STAGE = {
    "route.detect": "route_detect",
    "route.native_encode": "native_encode",
    "host.stage": "copy_in",
    "host.pack": "pack",
    "k1.decode_blocks": "launch",
    "k2.encode_blocks": "launch",
    "framed.crc": "crc",
    "host.wait": "wait",
}
COUNTERS = ("route.host_blocks", "route.device_blocks", "host.staged_bytes", "framed.crc_bytes", "trace.spans_dropped")


def stage_seconds(spans: list) -> tuple[dict, float]:
    """The recorded ``spans`` of one run as (self seconds by stage name,
    seconds inside the dispatch and assemble calls)."""
    by_id = {s.id: s for s in spans}
    stages: dict = defaultdict(float)
    calls = 0.0
    for s in spans:
        top = TOP.get(by_id[s.request].name, by_id[s.request].name) if s.request in by_id else s.name
        name = top if s.id == s.request else f"{top}.{STAGE.get(s.name, s.name)}"
        stages[name] += profiling.self_ns(s) / 1e9
        if s.id == s.request and top.startswith(("dispatch_", "assemble_")):
            calls += (s.end_ns - s.start_ns) / 1e9
    return dict(stages), calls


def profile(raw: bytes, blocks_per_frame: int, device) -> list[dict]:
    """The four turns of each direction over ``raw``: one record a run."""
    chunk = blocks_per_frame * BLOCK
    chunks = [raw[i : i + chunk] for i in range(0, len(raw), chunk)]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def pipelined_compress():
        dst = io.BytesIO()
        streaming.compress_stream(io.BytesIO(raw), dst, device=device, blocks_per_frame=blocks_per_frame)
        return dst

    def serial_compress():
        return [parallel.compress_framed(c, device=device) for c in chunks]

    def pipelined_uncompress(comp):
        dst = io.BytesIO()
        streaming.uncompress_stream(io.BytesIO(comp), dst, device=device)
        return dst

    def serial_uncompress(frames):
        return [parallel.uncompress_framed(f, device=device) for f in frames]

    records, comp, frames = [], None, None
    with profiling.recording():
        warm = io.BytesIO()
        streaming.compress_stream(io.BytesIO(chunks[0]), warm, device=device, blocks_per_frame=blocks_per_frame)
        streaming.uncompress_stream(io.BytesIO(warm.getvalue()), io.BytesIO(), device=device)
        for mode in ("pipelined", "serial", "serial", "pipelined"):
            for direction in ("compress", "uncompress"):
                sync()
                before = profiling.counters()
                start_ns = time.time_ns()
                t0 = time.perf_counter()
                if direction == "compress":
                    got = pipelined_compress() if mode == "pipelined" else serial_compress()
                else:
                    got = pipelined_uncompress(comp) if mode == "pipelined" else serial_uncompress(frames)
                wall = time.perf_counter() - t0
                moved = profiling.since(before)
                spans, calls = stage_seconds([s for s in profiling.spans() if s.start_ns >= start_ns])
                got = got.getvalue() if mode == "pipelined" else b"".join(got)
                if direction == "compress":
                    if comp is None:
                        comp = got
                        frames = list(streaming.iter_frames(io.BytesIO(comp)))
                    if got != comp:
                        raise RuntimeError(f"{mode} compress gave other bytes than the first run")
                elif got != raw:
                    raise RuntimeError(f"{mode} uncompress is not bit-exact")
                records.append({
                    "mode": mode,
                    "direction": direction,
                    "bytes": len(raw),
                    "frames": len(chunks),
                    "seconds": wall,
                    "gbps": len(raw) / wall / 1e9,
                    "spans": spans,
                    "counters": {k: moved[k] for k in COUNTERS},
                    "io_and_rest": wall - calls,
                })
    return records


def loader() -> dict:
    """The kernel loader's spans recorded in this process (ms, summed):
    its slow path (``kernels.load``) and the nvcc builds in it
    (``kernels.build``); nothing where no kernel was loaded while spans
    recorded."""
    return {name: sum(s.end_ns - s.start_ns for s in profiling.spans(name)) / 1e6
            for name in ("kernels.load", "kernels.build")}


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
    counters = ", ".join(f"{k} {v}" for k, v in r["counters"].items())
    return (f"{r['direction']:10s} {r['mode']:9s} {r['seconds']:.4f} s ({r['gbps']:.4f} GB/s), "
            f"{r['frames']} frames; self ms: {spans}; reads, writes and the rest {r['io_and_rest'] * 1e3:.1f}; "
            f"counters: {counters}")


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
    load = loader()
    print(f"kernel loader: kernels.load {load['kernels.load']:.1f} ms, of it kernels.build (nvcc) "
          f"{load['kernels.build']:.1f} ms", flush=True)
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
    print(json.dumps({"profile_stream": records, "loader": load, "fetch": fetch, "busy": busy}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
