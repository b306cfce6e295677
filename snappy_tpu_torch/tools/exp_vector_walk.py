"""The round-4 probes P1-P6 on one CUDA card: what one step of a tag walk or
of a record drain costs.

    python -m snappy_tpu_torch.tools.exp_vector_walk [chains|walks|drains|scalar|when|all] [--parent PATH]

The port of the timing functions of ``benchmarks/exp_vector_walk.py``, at the
script's sizes, with the kernels of ``csrc/exp_vector_walk.cu``:

  chains  P1: select chains on an (8, 128) state, G 1 and 4 interleaved,
          by gather and by reduce, and the chain on axis 0 and 1 and the ALU
          chain at G 1; 200,000 and 1,000,000 steps
  walks   P2, 8 walks in lockstep a group, and P3, one walk a block, on the
          same 64 blocks of synthetic tag chains (320 rows of 128 command
          words), P2 over 320 and 160 rows, P3 at knob 1 and 0
  drains  P4: 4096 and 1024 records, 8 a group (gather, logroll) and serial
  scalar  P5: the 8 scalar-loop variants, 100,000 and 900,000 steps
  when    P6: 262,144 and 32,768 records, second store always, when, none

The walks' chains draw advances from 2..7 (``synth_cmds(max_advance=7)``):
the script's 2..8 stores a copy of advance 8 as ``8 & 7 = 0``, on which
every walk stalls (P3 then runs to its step cap, P2 to its burst cap).

Each probe is first held against its plain version, bit for bit, at its
high knob (P2 and P3 also on the script's stalled data); P1 and P5, whose
plain versions step through every iteration, at a small knob. Then it is
timed at its two
knobs with CUDA events (``utils/metrics.time_device_fn``, median of 5 after
a warm-up), and the slope between them, which cancels launch and fixed
costs, gives ns a step. One more launch at each knob reads the kernel's own
clock64() span of its block 0, which gives cycles a step of that block
without assuming a clock rate. A step is an iteration (P1, P5), a tag (P2,
P3) or a record (P4, P6). For P2 and P3, ns a tag divide the launch by the
tags of all blocks, which run at once, as the script divided; cycles a tag
are those of block 0's own walks. Prints one line a probe, the card's name
and power limit, and last a JSON line ``{"probes": [...]}``. Requires a CUDA
card and nvcc.

With ``drains`` (or ``all``) it also reads 1 MiB and 4 MiB from L2 with one
block (``l2_rate``), the rate that bounds a one-block drain, and the JSON
line gains ``"l2_read"``.

``--parent PATH`` builds another copy of ``csrc/exp_vector_walk.cu``, such as
a parent commit's (``git show <commit>:snappy_tpu_torch/csrc/
exp_vector_walk.cu > PATH``), beside the current one, gates it against the
plain versions too and times it beside the current one, probe by probe
(parent first), in the same process: each probe's line is followed by the
parent's, and the JSON line gains ``"parent"``, the parent's records in the
same order.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..native.build import build_shared
from ..ops import cuda_probes, kernels, probes_torch
from ..ops.probes_torch import LANES, NCP, NREC, NSRC, R_ROWS, SCALAR_VARIANTS, WHEN_RECORDS
from ..utils.metrics import time_device_fn

WALK_GROUPS = 8  # P2's groups of 8 walks: 64 blocks, as the script
ITERS = 5


@dataclass
class Probe:
    """One kernel variant with its inputs: ``fn(knob, *args)`` is the
    wrapper, ``plain(knob, *args)`` the plain version."""

    name: str
    kernel: str  # one of cuda_probes.KERNELS
    fn: Callable
    plain: Callable
    args: tuple
    lo: int
    hi: int
    gate: int  # the knob at which the kernel is held against (and timed beside) the plain version
    steps: Callable[[int], tuple[int, int]]  # knob -> (steps of the launch, steps of block 0)
    unit: str
    ops_per_step: int  # integer operations a step, for the bound
    per: int = 1  # chains a step (P1's G)
    gate_args: list = field(default_factory=list)  # more inputs to gate on


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in (out if isinstance(out, tuple) else (out,)))


def chain_inputs(g: int, seed: int = 0) -> np.ndarray:
    """``run_chains``'s state: int32[G, 8, 128] in [0, 2**20)."""
    return np.random.default_rng(seed).integers(0, 1 << 20, (g, 8, LANES)).astype(np.int32)


def drain_inputs(seed: int = 1):
    """``run_drains``'s records: (q0, r, fld, src)."""
    rng = np.random.default_rng(seed)
    q0 = rng.integers(0, NSRC - 4, NREC).astype(np.int32)
    r = rng.integers(0, NSRC - 4, NREC).astype(np.int32)
    shift = rng.integers(0, 128, NREC)
    ph = (-shift) % 128
    lo = rng.integers(0, 128, NREC)
    n = rng.integers(1, 65, NREC)
    fldw = (shift | (ph << 7) | (lo << 14) | (n << 21)).astype(np.int32)
    fld = np.broadcast_to(fldw.reshape(NREC // 8, 8, 1), (NREC // 8, 8, LANES)).copy()
    src = rng.integers(0, 255, (NSRC, LANES)).astype(np.int32)
    return q0, r, fld, src


# Rows past either end of P4's output, and rows whose next ones wrap: the
# kernels and the plain versions clamp r (and r + 1) into the output and q0
# (and q0 + 1, q0 + 2) into the source, each sum wrapping as the
# reference's int32 arithmetic does.
DRAIN_EDGE_ROWS = (-1, -7, NSRC - 1, NSRC, NSRC + 6, NSRC + 7, NSRC + 8, 600, -(1 << 31), (1 << 31) - 1,
                   (1 << 31) - 2, (1 << 31) - 3)
DRAIN_EDGE_Q0 = DRAIN_EDGE_ROWS


def drain_gate_inputs(seed: int = 9) -> list[tuple]:
    """P4's inputs beside the script's: (q0, r, fld, src) with fields drawn
    per lane and every fourth record's row repeated by the next (a later
    record to the same row must win); and the same with q0 at
    ``DRAIN_EDGE_Q0`` and r at ``DRAIN_EDGE_ROWS``."""
    q0, r, fld, src = drain_inputs()
    fld = np.random.default_rng(seed).integers(0, 1 << 28, fld.shape).astype(np.int32)
    r[1::4] = r[::4]
    eq0, er = q0.copy(), r.copy()
    eq0[::5] = np.resize(np.array(DRAIN_EDGE_Q0, np.int32), eq0[::5].shape)
    er[2::7] = np.resize(np.array(DRAIN_EDGE_ROWS, np.int32), er[2::7].shape)
    return [(q0, r, fld, src), (eq0, er, fld, src)]


def when_inputs(seed: int = 3):
    """``run_when``'s records: (q, r, src); lo + n > 128 for ~15% of them."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 128, WHEN_RECORDS)
    n = np.where(rng.random(WHEN_RECORDS) < 0.15, 127 - np.minimum(lo, 63), rng.integers(1, 40, WHEN_RECORDS))
    q = (lo | (np.minimum(n, 63) << 7)).astype(np.int32)
    r = rng.integers(0, 500, WHEN_RECORDS).astype(np.int32)
    src = rng.integers(0, 255, (probes_torch.WHEN_SRC_ROWS, LANES)).astype(np.int32)
    return q, r, src


def tag_positions(words: np.ndarray) -> np.ndarray:
    """Positions of the tags a walk visits in one block of command words,
    until it leaves the block (the walk of a stall-free chain)."""
    w = words.tolist()
    pos, ip = [], 0
    while ip < len(w):
        pos.append(ip)
        x = w[ip]
        adv = (x & 7) + ((x >> 3) & 1) * ((x >> 4) & 0x7F)
        if adv == 0:
            raise ValueError(f"the walk stalls at position {ip}")
        ip += adv
    return np.array(pos, np.int64)


def chains(dev) -> list[Probe]:
    out = []
    jobs = [(mode, g) for g in (1, 4) for mode in ("gather", "reduce")] + [(m, 1) for m in ("axis0", "axis1", "alu")]
    ops = {"gather": 5, "reduce": 7, "axis0": 3, "axis1": 3, "alu": 3}
    for mode, g in jobs:
        x = torch.from_numpy(chain_inputs(g)).to(dev)
        label = f"{mode}-select chain" if mode in ("gather", "reduce") else f"{mode} chain"
        out.append(Probe(
            f"P1 {label} G={g}", "chain", functools.partial(cuda_probes.chain, mode=mode),
            functools.partial(probes_torch.chain, mode=mode), (x,), 200_000, 1_000_000, 50,
            lambda k: (k, k), "step", ops[mode] * g * 8 * LANES, per=g,
        ))
    return out


def walks(dev) -> list[Probe]:
    nblocks = WALK_GROUPS * 8
    cmds, _ = probes_torch.synth_cmds(nblocks, max_advance=7)
    ends = [tag_positions(b) for b in cmds]
    stalled, _ = probes_torch.synth_cmds(nblocks)
    clen8 = torch.full((WALK_GROUPS, 8, LANES), NCP, dtype=torch.int32, device=dev)
    clen1 = torch.full((nblocks, 1, 1), NCP, dtype=torch.int32, device=dev)

    def grouped(c):
        return torch.from_numpy(c.reshape(WALK_GROUPS, 8, R_ROWS, LANES).transpose(0, 2, 1, 3).copy()).to(dev)

    def rows_tags(k):  # tags before row k: of all blocks, of group 0's 8 walks
        n = [int((p < k * LANES).sum()) for p in ends]
        return sum(n), sum(n[:8])

    def walk_tags(k):  # live steps of P3 at knob k: of all blocks, of block 0
        cap = 16 * (k * NCP // 5 // 16 + 1)
        n = [min(cap, len(p)) for p in ends]
        return sum(n), n[0]

    def flat(c):
        return torch.from_numpy(c.reshape(nblocks, 1, NCP)).to(dev)

    return [
        Probe("P2 walk8 row-lockstep", "walk8", cuda_probes.walk8, probes_torch.walk8, (clen8, grouped(cmds)),
              R_ROWS // 2, R_ROWS, R_ROWS, rows_tags, "tag", 12, gate_args=[(clen8, grouped(stalled))]),
        Probe("P3 scalar walk", "walk_scalar", cuda_probes.walk_scalar, probes_torch.walk_scalar,
              (clen1, flat(cmds)), 0, 1, 1, walk_tags, "tag", 12, gate_args=[(clen1, flat(stalled))]),
    ]


def drains(dev) -> list[Probe]:
    args = tuple(torch.from_numpy(a).to(dev) for a in drain_inputs())
    more = [tuple(torch.from_numpy(a).to(dev) for a in g) for g in drain_gate_inputs()]
    out = []
    for mode, label in (("gather", "drain8 gather"), ("logroll", "drain8 logroll"), ("serial", "drain serial")):
        eight = mode != "serial"
        out.append(Probe(
            f"P4 {label}", "drain", functools.partial(cuda_probes.drain, mode=mode),
            functools.partial(probes_torch.drain, mode=mode), args, NREC // 4, NREC, NREC,
            (lambda k: (k // 8 * 8,) * 2) if eight else (lambda k: (k, k)), "record", 10 * LANES, gate_args=more,
        ))
    return out


READ_TILES = (64, 256)  # the one-block read's sizes: 1 MiB and 4 MiB of 16 KiB tiles


def l2_rate(dev, lib=None) -> dict:
    """The rate at which one SM takes words in from L2: the one-block read
    (``cuda_probes.l2_read``, a ring of cp.async copies as the drains') of 1
    MiB and 4 MiB, each held against its plain version first (exact), then
    resident in L2 after a warm-up launch; bytes a cycle and GB/s by the
    slope of the two sizes (median of ITERS launches each, the kernel's
    clock64() span and CUDA events). ``lib``: another build of the source,
    as ``--parent``."""
    tile = cuda_probes.READ_TILE
    read = functools.partial(cuda_probes.l2_read, lib=lib)
    x = torch.from_numpy(np.random.default_rng(4).integers(-(1 << 31), 1 << 31, READ_TILES[-1] * tile)
                         .astype(np.int32)).to(dev)
    cyc, ms = {}, {}
    for t in READ_TILES:
        part = x[: t * tile]
        if not torch.equal(read(part), probes_torch.xor_words(part)):
            raise RuntimeError(f"the one-block read of {t} tiles and its plain version differ")
        ms[t] = time_device_fn(read, (part,), iters=ITERS, warmup=1) * 1e3
        runs = []
        for _ in range(ITERS):
            c = torch.zeros(1, dtype=torch.int64, device=dev)
            read(part, cycles=c)
            runs.append(int(c.item()))
        cyc[t] = sorted(runs)[ITERS // 2]
    lo, hi = READ_TILES
    nbytes = (hi - lo) * tile * 4
    return {"bytes_per_cycle": nbytes / (cyc[hi] - cyc[lo]), "gb_per_s": nbytes / ((ms[hi] - ms[lo]) * 1e6),
            "cycles_lo": cyc[lo], "cycles_hi": cyc[hi], "ms_lo": ms[lo], "ms_hi": ms[hi], "tiles": list(READ_TILES)}


def scalar(dev) -> list[Probe]:
    x = torch.from_numpy((np.arange(1024) % 7).astype(np.int32)).to(dev)
    out = []
    for label, work, unroll, cond, chain in SCALAR_VARIANTS:
        kw = dict(work=work, unroll=unroll, cond=cond, chain=chain)
        out.append(Probe(
            f"P5 {label}", "scalar_loop", functools.partial(cuda_probes.scalar_loop, **kw),
            functools.partial(probes_torch.scalar_loop, **kw), (x,), 100_000, 900_000, 300,
            lambda k, u=unroll: (-(-k // u) * u,) * 2, "step", 3 * work + 3 * cond + 7 * chain + 1,
        ))
    return out


# Rows past either end of P6's output, and one whose next row wraps: the
# kernel clamps them into the output as the plain version does.
WHEN_EDGE_ROWS = (-1, -7, 502, 503, 504, 600, -(1 << 31), (1 << 31) - 1)


def when(dev) -> list[Probe]:
    q, r, src = when_inputs()
    edges = r.copy()
    edges[::5] = np.resize(np.array(WHEN_EDGE_ROWS, np.int32), edges[::5].shape)
    args = tuple(torch.from_numpy(a).to(dev) for a in (q, r, src))
    edge_args = (args[0], torch.from_numpy(edges).to(dev), args[2])
    return [
        Probe(f"P6 drain2nd {mode}", "when_drain", functools.partial(cuda_probes.when_drain, mode=mode),
              functools.partial(probes_torch.when_drain, mode=mode), args, WHEN_RECORDS * 8, WHEN_RECORDS * 64,
              WHEN_RECORDS * 64, lambda k: (k // 8 * 8,) * 2, "record", 10 * LANES, gate_args=[edge_args])
        for mode in probes_torch.WHEN_MODES
    ]


GROUP_PROBES = {"chains": chains, "walks": walks, "drains": drains, "scalar": scalar, "when": when}
GROUPS = tuple(GROUP_PROBES)


def probes(which: str, dev) -> list[Probe]:
    """The probes of one group, or of all five, with their inputs on ``dev``."""
    if which != "all" and which not in GROUP_PROBES:
        raise ValueError(f"expected one of {GROUPS + ('all',)}, got {which!r}")
    return [p for g in (GROUPS if which == "all" else (which,)) for p in GROUP_PROBES[g](dev)]


def _outputs(res) -> tuple:
    return res if isinstance(res, tuple) else (res,)


def gate(p: Probe) -> dict:
    """Hold the kernel against its plain version at ``p.gate`` on every
    input set; raises if any output differs. Returns the largest difference
    (0), and the plain version's time (one call) and the kernel's (median of
    ITERS) at ``p.gate`` on the first input set."""
    plain_ms = None
    for args in [p.args, *p.gate_args]:
        runs = []
        ms = time_device_fn(lambda *a: runs.append(p.plain(p.gate, *a)), args, iters=1, warmup=0) * 1e3
        plain_ms = ms if plain_ms is None else plain_ms
        got = _outputs(p.fn(p.gate, *args))
        want = _outputs(runs[0])
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                err = int((g.long() - w.long()).abs().max()) if g.shape == w.shape else -1
                raise RuntimeError(f"{p.name}: kernel and plain version differ at knob {p.gate} (max |diff| {err})")
    kernel_ms = time_device_fn(p.fn, (p.gate, *p.args), iters=ITERS, warmup=1) * 1e3
    return {"max_abs_err": 0, "plain_ms": plain_ms, "plain_knob": p.gate, "kernel_ms": kernel_ms}


def gate_parent(p: Probe) -> None:
    """Gate a parent's copy as ``gate`` does; where it differs only on the
    inputs beside the script's (``gate_args``, which an older copy was not
    held to), say so and gate it on the script's inputs alone."""
    try:
        gate(p)
    except RuntimeError as e:
        if not p.gate_args:
            raise
        print(f"parent {e}; on the script's inputs alone:", flush=True)
        gate(dataclasses.replace(p, gate_args=[]))


def measure(p: Probe) -> dict:
    """Time ``p`` at its two knobs; ns and cycles a step by the slope."""
    dev = p.args[0].device
    ms = {k: time_device_fn(p.fn, (k, *p.args), iters=ITERS, warmup=1) * 1e3 for k in (p.lo, p.hi)}
    cyc = {}
    for k in (p.lo, p.hi):
        c = torch.zeros(1, dtype=torch.int64, device=dev)
        out = p.fn(k, *p.args, cycles=c)
        cyc[k] = int(c.item())
    (s_lo, b_lo), (s_hi, b_hi) = p.steps(p.lo), p.steps(p.hi)
    ns = (ms[p.hi] - ms[p.lo]) * 1e6 / (s_hi - s_lo)
    cycles = (cyc[p.hi] - cyc[p.lo]) / (b_hi - b_lo)
    return {
        "probe": p.name, "kernel": p.kernel, "unit": p.unit, "ns_per_step": ns, "cycles_per_step": cycles,
        "cycles_per_chain_step": cycles / p.per, "ms_lo": ms[p.lo], "ms_hi": ms[p.hi], "knob_lo": p.lo,
        "knob_hi": p.hi, "steps_lo": s_lo, "steps_hi": s_hi, "cycles_lo": cyc[p.lo], "cycles_hi": cyc[p.hi],
        "in_bytes": sum(_nbytes(a) for a in p.args), "out_bytes": _nbytes(out), "ops": p.ops_per_step * s_hi,
    }


def line(r: dict) -> str:
    extra = f" ({r['cycles_per_chain_step']:.2f} cycles a chain-step)" if r["probe"].startswith("P1") else ""
    return (f"{r['probe']:30s} {r['ns_per_step']:9.3f} ns/{r['unit']} = {r['cycles_per_step']:8.2f} cycles/"
            f"{r['unit']}{extra}; {r['ms_hi']:.4f} ms at knob {r['knob_hi']}, {r['ms_lo']:.4f} ms at {r['knob_lo']}")


def run(ps: list[Probe], prefix: str = "") -> list[dict]:
    """Time every probe, printing a line each; the records, in order."""
    out = []
    for p in ps:
        out.append(measure(p))
        print(prefix + line(out[-1]), flush=True)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0].strip()


def build_copy(path: Path, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Another copy of the probes' source, built beside the current one
    (nvcc, the same flags and ``-D`` each of ``defines``) and bound with the
    same entry points."""
    compiler = [str(kernels.nvcc_path()), *kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    lib = ctypes.CDLL(str(build_shared(compiler, [path], "snappy_cuda_exp_vector_walk_copy")))
    for name, (restype, argtypes) in kernels.ENTRIES["exp_vector_walk"].items():
        if hasattr(lib, name):  # an older copy may lack an entry point that no probe calls
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def on_copy(p: Probe, lib: ctypes.CDLL) -> Probe:
    """``p`` with its wrapper launching ``lib``'s kernel."""
    return dataclasses.replace(p, fn=functools.partial(p.fn, lib=lib))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.exp_vector_walk")
    ap.add_argument("group", nargs="?", default="all", choices=(*GROUPS, "all"))
    ap.add_argument("--parent", type=Path, help="another copy of exp_vector_walk.cu, timed beside this one")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    if args.parent is not None and not args.parent.is_file():
        print(f"exp_vector_walk: no file {args.parent}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_vector_walk: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = card()
    print(f"device: {torch.cuda.get_device_name(0)} ({name})", flush=True)
    parent = build_copy(args.parent) if args.parent is not None else None
    results, parents = [], []
    for group in GROUPS if args.group == "all" else (args.group,):
        ps = probes(group, dev)
        for p in ps:
            gate(p)
            if parent is not None:
                gate_parent(on_copy(p, parent))
        copies = " (and the parent's)" if parent is not None else ""
        print(f"{group}: {len(ps)} probes{copies} identical to their plain versions", flush=True)
        for p in ps:
            if parent is not None:
                parents += run([on_copy(p, parent)], prefix="parent ")
            results += run([p])
    record = {"probes": results}
    if args.group in ("drains", "all"):
        record["l2_read"] = l2_rate(dev)
        rate = record["l2_read"]
        print(f"one-block L2 read: {rate['bytes_per_cycle']:.2f} bytes/cycle, {rate['gb_per_s']:.2f} GB/s "
              f"({rate['ms_hi']:.4f} ms for {READ_TILES[-1] * 16} KiB)", flush=True)
    print(name, flush=True)
    if parent is not None:
        record["parent"] = parents
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
