"""Whole framed calls on one device, with and without a mesh, in turns.

    python -m snappy_tpu_torch.tools.profile_mesh [--bytes N] [--shards 1,4] [--turns 7] [--device DEV]

Codes N bytes of the corpus mix (``profile_stream.corpus_stream``; default
64 MiB, ``chip_smoke.py``'s main size) through ``compress_framed`` and
``uncompress_framed`` in one process: routed on ``device`` and over meshes
of each shard count, every shard on ``device``; decoding the routed frame
and the mesh frame on ``device``, and the mesh frame over each mesh. After
one untimed turn, each turn runs every variant once, in reverse order
every other turn, so the variants share the process's history (its
allocator's state, the card's clocks). Every output is checked: a frame
against the first of its path, a decode against the input. Prints the
card's name and power limit, one line a variant (host clock: min, median
and every turn) and a ``{"profile_mesh": [...]}`` line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ..parallel import distributed, host
from .profile_stream import corpus_stream


def variants(raw: bytes, device, shards: list[int]) -> dict:
    """name -> (call, the bytes it must return) of each variant."""
    meshes = {k: distributed.mesh_1d([device] * k) for k in shards}
    routed = host.compress_framed(raw, device=device)
    meshed = host.compress_framed(raw, mesh=meshes[shards[0]])
    runs = {"compress routed": (lambda: host.compress_framed(raw, device=device), routed)}
    for k, m in meshes.items():
        runs[f"compress mesh {k}"] = (lambda m=m: host.compress_framed(raw, mesh=m), meshed)
    runs["uncompress routed frame"] = (lambda: host.uncompress_framed(routed, device=device), raw)
    runs["uncompress mesh frame"] = (lambda: host.uncompress_framed(meshed, device=device), raw)
    for k, m in meshes.items():
        runs[f"uncompress mesh frame, mesh {k}"] = (lambda m=m: host.uncompress_framed(meshed, mesh=m), raw)
    return runs


def profile(raw: bytes, device, shards: list[int], turns: int) -> list[dict]:
    """One record a variant: its seconds in every turn."""
    runs = variants(raw, device, shards)
    for fn, _ in runs.values():  # one warm-up turn: the kernels' first build and load
        fn()
    seconds = {name: [] for name in runs}
    for turn in range(turns):
        order = list(runs.items())
        for name, (fn, expect) in order if turn % 2 == 0 else order[::-1]:
            t0 = time.perf_counter()
            got = fn()
            seconds[name].append(time.perf_counter() - t0)
            if got != expect:
                raise RuntimeError(f"{name} gave other bytes")
    return [{"variant": name, "bytes": len(raw), "seconds": ts, "min": min(ts), "median": statistics.median(ts)}
            for name, ts in seconds.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_mesh", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bytes", type=int, default=64 << 20)
    p.add_argument("--shards", default="1,4", help="shard counts, comma-separated")
    p.add_argument("--turns", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    else:
        print(f"device {args.device} (no card: host times only)", flush=True)
    records = profile(corpus_stream(args.bytes), args.device, [int(k) for k in args.shards.split(",")], args.turns)
    for r in records:
        print(f"{r['variant']:34s} min {r['min']:.4f} s, median {r['median']:.4f} s of "
              f"{[round(t, 4) for t in r['seconds']]}", flush=True)
    print(json.dumps({"profile_mesh": records}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
