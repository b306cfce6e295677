"""Where the array encoder's time goes: by stage, by step of its match
extension, and against another copy of it, in turns.

    python -m snappy_tpu_torch.tools.profile_array [--bytes N] [--turns 3] [--source PATH] [--device DEV]

Encodes the rows of N bytes of the corpus mix (``corpus.corpus_stream``;
default 64 MiB, ``chip_smoke.py``'s main size, whose 973 rows routing leaves
on the device) with ``ops/encode_array.py``:
- one call split by stage (candidates, the extension's chain links,
  doubling and end-lane loop, the two parses, emission; ``split``), with
  the end-lane loop's rounds and live lanes a round;
- on a card, ``torch.profiler``'s device time over one call beside its
  wall time, and the kernels that take most of it;
- the device time of a call (median of 5), in turns with the copy of
  ``encode_array.py`` at ``--source`` (loaded into this package, so its
  relative imports resolve here), which must write the same bytes.
Stages are timed with CUDA events on a card and the host clock on the CPU.
Prints the card's name and power limit, a line a measurement and a
``{"profile_array": {...}}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ..ops import encode_array, route
from ..ops.host import blockify, to_device
from ..utils.metrics import time_device_fn
from .corpus import corpus_stream

BLOCK = 1 << 16
# The functions of encode_array.py timed by ``split``, by stage name.
STAGES = {
    "candidates": "_find_candidates",
    "extension": "_match_lengths",
    "links": "_chain_links",
    "doubling": "_follow_chains",
    "end_loop": "_extend_ends",
    "parse": "_parse",
    "emission": "_emit",
}


def device_rows(raw: bytes, device):
    """(blocks, blens) on ``device``: the 64 KiB blocks of ``raw`` that
    routing leaves on the device, as ``compress_framed`` cuts them."""
    buf, blens = blockify(np.frombuffer(raw, np.uint8), BLOCK)
    keep = np.setdiff1d(np.arange(len(blens)), route.host_blocks(buf, blens))
    return to_device(buf[keep], device), to_device(blens[keep], device)


def load_source(path: str):
    """The copy of ``encode_array.py`` at ``path`` as a module of this
    package (``snappy_tpu_torch.ops.profiled_source``)."""
    spec = importlib.util.spec_from_file_location("snappy_tpu_torch.ops.profiled_source", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """CUDA events on a card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@contextlib.contextmanager
def _wrapped(mod, wrappers: dict):
    """``mod``'s functions replaced by ``wrappers`` (name -> wrap(fn)) while
    the block is open."""
    saved = {name: getattr(mod, name) for name in wrappers if hasattr(mod, name)}
    try:
        for name, fn in saved.items():
            setattr(mod, name, wrappers[name](fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)


def split(blocks: torch.Tensor, blens: torch.Tensor, mod=encode_array) -> dict:
    """One call of ``mod.encode_blocks`` by stage: {"stage_ms": ms summed
    over the row chunks by stage, "call_ms", "rounds" and "live_lanes" (the
    end-lane loop's rounds, summed over the chunks, and its live lanes a
    round)}. The output must equal an untimed call's."""
    clock = _Clock(blocks.device)
    marks: dict[str, list] = {}
    live: list[int] = []

    def timed(stage):
        def wrap(fn):
            def run(*a):
                start = clock.mark()
                res = fn(*a)
                marks.setdefault(stage, []).append((start, clock.mark()))
                return res
            return run
        return wrap

    def counted(fn):
        # Called once a round of the end-lane loop, on its live lanes.
        def run(x):
            live.append(x.numel())
            return fn(x)
        return run

    want = mod.encode_blocks(blocks, blens)
    wrappers = {fn: timed(stage) for stage, fn in STAGES.items()} | {"_equal_leading_bytes": counted}
    with _wrapped(mod, wrappers):
        start = clock.mark()
        got = mod.encode_blocks(blocks, blens)
        end = clock.mark()
    if clock.cuda:
        torch.cuda.synchronize(blocks.device)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("the timed call gave other bytes")
    stage_ms = {stage: sum(clock.ms(a, b) for a, b in marks[stage]) for stage in STAGES if stage in marks}
    return {"stage_ms": stage_ms, "call_ms": clock.ms(start, end), "rounds": len(live), "live_lanes": live}


def device_profile(blocks: torch.Tensor, blens: torch.Tensor, top: int = 8) -> dict:
    """``torch.profiler`` over one call on a card: the device's busy ms (the
    kernels' self time) beside the call's wall ms, and the ``top`` kernels'
    ms by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(blocks.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode_array.encode_blocks(blocks, blens)
        torch.cuda.synchronize(blocks.device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    return {"busy_ms": busy, "wall_ms": wall * 1e3,
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])}


def turns(blocks: torch.Tensor, blens: torch.Tensor, mods: dict, n_turns: int) -> dict:
    """Device ms of a call (median of 5) of each module's encoder, in
    turns, every other turn in reverse order: name -> [ms a turn]."""
    out = {name: [] for name in mods}
    for turn in range(n_turns):
        order = list(mods.items())
        for name, mod in order if turn % 2 == 0 else order[::-1]:
            out[name].append(time_device_fn(mod.encode_blocks, (blocks, blens), iters=5, warmup=1) * 1e3)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_array", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bytes", type=int, default=64 << 20)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--source", help="another copy of ops/encode_array.py to time in turns")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
    else:
        card = f"device {args.device} (no card: host times only)"
    print(card, flush=True)
    blocks, blens = device_rows(corpus_stream(args.bytes), device)
    record = {"card": card, "rows": blocks.shape[0], "rows_a_chunk": encode_array.rows_per_chunk(blocks.shape[1], device)}
    record["split"] = split(blocks, blens)
    s = record["split"]
    print(f"{record['rows']} rows ({record['rows_a_chunk']} a chunk), one call {s['call_ms']:.4f} ms by stage: "
          f"{ {k: round(v, 4) for k, v in s['stage_ms'].items()} }; end-lane loop {s['rounds']} rounds, "
          f"{sum(s['live_lanes'])} lane-rounds, first {s['live_lanes'][:4]}", flush=True)
    if device.type == "cuda":
        record["profiler"] = device_profile(blocks, blens)
        prof = record["profiler"]
        print(f"torch.profiler: the device busy {prof['busy_ms']:.4f} ms of a {prof['wall_ms']:.4f} ms call; top "
              f"{[(round(v, 4), k[:70]) for k, v in prof['top_ms'].items()]}", flush=True)
    mods = {"encode_array": encode_array}
    if args.source:
        other = load_source(args.source)
        got, want = other.encode_blocks(blocks, blens), encode_array.encode_blocks(blocks, blens)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"{args.source} writes other bytes than ops/encode_array.py")
        mods["source"] = other
    record["turns_ms"] = turns(blocks, blens, mods, args.turns)
    for name, ts in record["turns_ms"].items():
        print(f"{name:13s} median {statistics.median(ts):.4f} ms of {[round(t, 4) for t in ts]}", flush=True)
    print(json.dumps({"profile_array": record}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
