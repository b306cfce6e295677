"""The readings a cell's limits are set from, at the cell's own size.

    python3 -m perfbench.control --workload <cell> --seeds 1,2,3 [--program] [--fault F]

For each seed, set-up is that of ``run.py``: the same blocks, the same
resident batches, and the same batches judged (each resident batch and
the runs the seed draws). Each is then produced by the control in the
program's place (``entries/<entry>.py::control``: the reference decoder
with copies moved as one block, or the frozen encoder trusting its hash
table), and judged as a run judges it. ``--program`` also judges the
program's own results of the same batches, and ``--fault F`` those of the
program with ``faults.py``'s fault F planted. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from perfbench import faults
from perfbench.registry import Registry
from perfbench.run import Refused, card, drawn_runs, sync


def judged_batches(n: int, seed: int) -> list[int]:
    """The batches a run with ``seed`` judges: those of the runs drawn from
    the seed, then every resident batch once."""
    return [i % n for i in sorted(drawn_runs(n, seed))] + list(range(n))


def readings(workload: str, seed: int, program: bool, fault: str | None, *, registry=None, device=None) -> dict:
    reg = registry or Registry()
    w = reg.workload(workload)
    cell, config = reg.cell(workload), reg.config(w["config"])
    device = device or card(w["chips"])
    entry = reg.entry(cell["entry"])
    state = entry.prepare(reg.generator(config["generator"]).generate(config, seed, device), config, cell, device)
    batches = judged_batches(entry.batches(state), seed)
    out = {"workload": workload, "seed": seed, "rows_judged": len(batches) * state.rows}
    sources = {"control": entry.control}
    if program:
        sources["program"] = entry.call
    if fault:
        sources[f"fault_{fault}"] = faults.plant(fault, entry.call)
    for name, fn in sources.items():
        wrong = 0
        for b in batches:
            result = fn(state, b)
            sync(device)
            wrong += entry.wrong_rows(state, b, result)
        out[f"{name}_rows_wrong"] = wrong
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.control", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", choices=faults.FAULTS)
    args = p.parse_args(argv)
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(readings(args.workload, seed, args.program, args.fault)), flush=True)
            torch.cuda.empty_cache()
    except Refused as e:
        print(f"perfbench.control: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
