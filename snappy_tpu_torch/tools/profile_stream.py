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
detector (``route.host_blocks``), the copy to the device, the kernel's
launch and the routed blocks' host encode; for decode the batch's packing
(``host.frame_batch``), the copy to the device, the launch and the crc
check (``framed.verify_crcs``). What dispatch holds beyond its stages is
cutting blocks and taking crcs (encode) or parsing the index (decode).
On a CUDA device each assemble first waits for the card
(``torch.cuda.synchronize``), which its first copy back would do anyway,
and that wait is timed apart: the time the host stands idle for the card.
What the wall time holds beyond dispatch and assemble is reading and
writing the streams. The card's name and power limit come first, one line
a run, and a ``{"profile_stream": [...]}`` line last.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from .. import parallel
from ..ops import route
from ..parallel import framed, streaming
from ..parallel import host as phost

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
    wait = torch.device(device).type == "cuda"
    targets = [  # (module, function, span)
        (phost, "dispatch_compress", "dispatch_compress"),
        (route, "host_blocks", "dispatch_compress.route_detect"),
        (route, "to_device", "dispatch_compress.copy_in"),
        (route, "block_encoder", "dispatch_compress.launch"),
        (route, "native_streams_for", "dispatch_compress.native_encode"),
        (phost, "assemble_compress", "assemble_compress"),
        (phost, "dispatch_uncompress", "dispatch_uncompress"),
        (phost, "frame_batch", "dispatch_uncompress.pack"),
        (phost, "to_device", "dispatch_uncompress.copy_in"),
        (phost, "block_decoder", "dispatch_uncompress.launch"),
        (phost, "assemble_uncompress", "assemble_uncompress"),
        (framed, "verify_crcs", "assemble_uncompress.crc"),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def timing(span, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            if wait and span.startswith("assemble"):
                torch.cuda.synchronize()
                spans[f"{span}.wait"] += time.perf_counter() - t0
            try:
                return fn(*args, **kw)
            finally:
                spans[span] += time.perf_counter() - t0

        return run

    def timing_launch(span, select):
        # block_encoder and block_decoder return the wrapper that launches.
        return lambda device: timing(span, select(device))

    try:
        for mod, name, span in targets:
            fn = getattr(mod, name)
            setattr(mod, name, timing_launch(span, fn) if name.startswith("block_") else timing(span, fn))
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
                    got = pipelined_compress() if mode == "pipelined" else serial_compress()
                else:
                    got = pipelined_uncompress(comp) if mode == "pipelined" else serial_uncompress(frames)
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
    records = profile(corpus_stream(args.bytes), args.blocks_per_frame, args.device)
    for r in records:
        print(line(r), flush=True)
    print(json.dumps({"profile_stream": records}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
