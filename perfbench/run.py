"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``snappy_tpu_torch``). The cell (``cells/<cell>.json``) names
its configuration, entry and dispatch depth; the configuration
(``configs/<config>.json``) its sizes and data generator. Set-up makes the
blocks from the seed, puts the entry's resident batches on the card, and
warms the entry up on as many results as the window keeps. The window then
submits batches back to back, batch k after batch k - depth's event,
cycling through the resident batches, for ``--seconds`` and at least one
cycle; it waits for the last before it closes. ``memory_peak_bytes`` is the
window's peak: the resident batches and the results it holds, set-up's
scratch left out. Once the window has closed, the result of each resident
batch's last run and of a few runs drawn from the seed are judged against
the blocks the seed made (``entries/<entry>.py``). A run that built a
library into one of the checkout's build directories (``*/_build/``), as
the first run in a checkout builds K1 or K2, names it under ``built``.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from a ``torch.profiler`` trace of the
window; each is read by ``metrics/<metric>.py``. Standard error ends with
each number judged beside its limit, and the line's last key, ``checks``,
holds them too. Without a card, or with fewer than the cell asks for, the
run exits 2 and prints no result; so it does where ``jax``, ``jaxlib``,
``flax`` or ``snappy_tpu`` was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import timeline
from perfbench.registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "snappy_tpu")
EXTRA_KEPT = 4  # runs drawn from the seed that are judged besides each batch's last
EXIT_REFUSED = 2


class Refused(Exception):
    """The run cannot give a result: no card, too few, or a forbidden module."""


def process_start() -> float:
    """Seconds on ``time.monotonic``'s clock at which this process began."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.monotonic() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules(names) -> list[str]:
    """The module names whose top-level name is one of ``FORBIDDEN``, the
    whole name before the first dot compared."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def drawn_runs(n: int, seed: int) -> set[int]:
    """The runs, by their place in the window, whose results are judged
    besides each resident batch's last: drawn from the seed among the
    second and third cycles through the ``n`` resident batches."""
    rng = np.random.default_rng(seed)
    return {int(x) for x in rng.choice(np.arange(n, 3 * n), size=min(EXTRA_KEPT, 2 * n), replace=False)}


def build_products(root: Path) -> set[str]:
    """The files under the build directories (``*/_build/``) of the
    checkout at ``root``, by their path from it."""
    return {str(f.relative_to(root)) for d in root.glob("*/_build") for f in d.rglob("*") if f.is_file()}


def card(chips: int) -> torch.device:
    """The first card, its context made, where there are ``chips`` cards."""
    if not torch.cuda.is_available():
        raise Refused("no CUDA card is visible")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are visible")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    return device


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Fence:
    """An event behind a submitted batch; on the CPU, where calls are
    synchronous, nothing."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    seconds: float = 0.0
    batches: int = 0
    work: list = field(default_factory=list)
    entry_s: list = field(default_factory=list)
    kept: list = field(default_factory=list)  # (batch, result)


def drive(entry, state, device, n: int, depth: int, seconds: float, extra: set[int], traced: bool) -> Window:
    """Submit batches back to back for ``seconds``, and at least once each;
    keep each resident batch's last result and those of the runs in
    ``extra``."""
    span = torch.profiler.record_function if traced else (lambda name: contextlib.nullcontext())
    w = Window()
    last: dict[int, tuple] = {}
    fences: deque[Fence] = deque()
    t0 = time.perf_counter()
    with span(timeline.WINDOW_SPAN):
        i = 0
        while True:
            if len(fences) >= depth:
                with span("perfbench.wait"):
                    fences.popleft().wait()
            b = i % n
            with span("perfbench.entry"):
                t = time.perf_counter()
                result = entry.call(state, b)
                w.entry_s.append(time.perf_counter() - t)
            with span("perfbench.submit"):
                fences.append(Fence(device))
                w.work.append(entry.work(state, b, result))
                last[b] = result
                if i in extra:
                    w.kept.append((b, result))
            i += 1
            if i >= n and time.perf_counter() - t0 >= seconds:
                break
        with span("perfbench.drain"):
            sync(device)
    w.seconds = time.perf_counter() - t0
    w.batches = i
    w.kept += sorted(last.items(), key=lambda kv: kv[0])
    return w


@dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    direction: str
    device_kind: str
    setup_s: float
    window_s: float
    batches: int
    rows: int
    bytes: int  # uncompressed bytes decoded or encoded in the window
    comp_bytes: int  # stream bytes read (decode) or written (encode) in the window
    entry_s: list
    trace: timeline.Trace | None = None


def traced(fn):
    """``fn()`` under ``torch.profiler`` with the card's activity: its
    result and the trace's window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            result = fn()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return result, timeline.read(path)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, registry: Registry | None = None,
             device: torch.device | None = None, started: float | None = None) -> dict:
    """One run of ``workload``: the result line as a dict. ``device`` set
    skips the look for a card (tests)."""
    started = time.monotonic() if started is None else started
    phases: dict[str, float] = {}
    at = [started]

    def phase(name: str) -> None:
        now = time.monotonic()
        phases[name] = now - at[0]
        at[0] = now

    phase("process_and_imports")
    reg = registry or Registry()
    products = build_products(reg.root.parent)
    w = reg.workload(workload)
    cell = reg.cell(workload)
    config = reg.config(w["config"])
    if device is None:
        device = card(w["chips"])
    entry = reg.entry(cell["entry"])
    phase("card")
    blocks = reg.generator(config["generator"]).generate(config, seed, device)
    phase("data")
    state = entry.prepare(blocks, config, cell, device)
    del blocks
    phase("prepare")
    n, depth = entry.batches(state), cell["depth"]
    extra = drawn_runs(n, seed)

    # Warm up on as many results as the window holds at once.
    held = [entry.call(state, i % n) for i in range(n + len(extra) + depth)]
    sync(device)
    del held
    phase("warm_up")
    setup_s = time.monotonic() - started
    built = sorted(build_products(reg.root.parent) - products)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def window():
        return drive(entry, state, device, n, depth, seconds, extra, trace)

    win, tl = traced(window) if trace else (window(), None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    sums = {k: sum(int(x.sum()) if isinstance(x, torch.Tensor) else int(x) for x in (d[k] for d in win.work))
            for k in ("rows", "bytes", "comp_bytes")}
    run = Run(workload, entry.DIRECTION, torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
              setup_s, win.seconds, win.batches, sums["rows"], sums["bytes"], sums["comp_bytes"], win.entry_s, tl)
    kept = win.kept
    del win
    t = time.monotonic()
    wrong = sum(entry.wrong_rows(state, b, result) for b, result in kept)
    judge_s = time.monotonic() - t
    checks = {
        "rows_wrong": {"value": wrong, "limit": 0, "rule": "<="},
        "batches_judged": {"value": len(kept), "limit": n, "rule": ">="},
    }
    correct = all(c["value"] <= c["limit"] if c["rule"] == "<=" else c["value"] >= c["limit"]
                  for c in checks.values())
    metrics = {}
    for name in reg.metric_names(workload, trace):
        reader = reg.metric(name)
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": run.device_kind,
           "count": w["chips"] if device.type == "cuda" else 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": run.rows, "failed": wrong, "metrics": metrics, "device": dev}
    if tl is not None:
        dev["busy_s"] = tl.busy_s
        dev["window_s"] = tl.window_s
        result["breakdown"] = {"device_ops": tl.device_ops(), "idle_gaps": tl.idle_gaps()}
    result["setup_phases_s"] = phases
    result["judge_s"] = judge_s
    result["built"] = built
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), started=started)
        found = forbidden_modules(sys.modules)
        if found:
            raise Refused(f"modules that may not be loaded were: {', '.join(found)}")
    except Refused as e:
        print(f"perfbench: {e}; no result", file=sys.stderr)
        return EXIT_REFUSED
    print("setup_s by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in result["setup_phases_s"].items())
          + f"; judged in {result['judge_s']:.3f} s", file=sys.stderr)
    print("built during set-up: " + (", ".join(result["built"]) or "nothing"), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} {c['rule']} {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
