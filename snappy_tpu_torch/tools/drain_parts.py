"""Where a one-block drain's time goes: the probe P4's kernels timed whole and
with their stores, or their stores and compute, cut out of a build of the
source, beside the one-block L2 read.

    python -m snappy_tpu_torch.tools.drain_parts [--json PATH]

Builds ``csrc/exp_vector_walk.cu`` three ways (nvcc, as ``tools/
exp_vector_walk.py --parent`` builds a copy), all at once, each with the
source's own switches (``-D``):

  kernel      the source as it is
  no_stores   SNAPPY_DRAIN_STORES=0: without the drains' stores (serial's
              loads then go dead too)
  ring_only   also SNAPPY_DRAIN_COMPUTE=0: drain8 without its compute, the
              copies into the ring, the barrier and the loop alone

and times each drain probe on each (cycles a record by the slope of the
kernel's clock64() span, the tool's ``measure``) and the one-block read
(bytes a cycle, the tool's ``l2_rate``). Where something is cut the outputs
are wrong, so no cut build is gated; the kernel itself is gated by
``tools/exp_vector_walk.py``. Prints a line a build and the card's name and
power limit, then a JSON line ``{"drain_parts": {...}}``. Requires a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import CSRC
from . import exp_vector_walk as evw

# build -> the -D switches of the source it is built with
CUTS = {
    "kernel": (),
    "no_stores": ("SNAPPY_DRAIN_STORES=0",),
    "ring_only": ("SNAPPY_DRAIN_STORES=0", "SNAPPY_DRAIN_COMPUTE=0"),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.drain_parts")
    ap.add_argument("--json", type=Path, help="also write the JSON record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drain_parts: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    source = CSRC / "exp_vector_walk.cu"
    with ThreadPoolExecutor(len(CUTS)) as ex:
        libs = dict(zip(CUTS, ex.map(lambda defines: evw.build_copy(source, defines), CUTS.values())))
    probes = evw.drains(dev)
    record = {}
    for name, lib in libs.items():
        row = {p.name: evw.measure(evw.on_copy(p, lib))["cycles_per_step"] for p in probes}
        row["l2_read_bytes_per_cycle"] = evw.l2_rate(dev, lib)["bytes_per_cycle"]
        record[name] = row
        print(f"{name:10s} " + ", ".join(f"{k} {v:.2f}" for k, v in row.items()), flush=True)
    print(evw.card(), flush=True)
    line = json.dumps({"drain_parts": record})
    if args.json is not None:
        args.json.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
