"""Where K3's cycles go, by phase, on one CUDA card, beside another copy of it.

    python -m snappy_tpu_torch.tools.profile_decode_r4 [--parent PATH] [--json PATH]

Builds an instrumented copy of ``csrc/decode_blocks_r4.cu`` into the build
directory, and of ``--parent`` (another copy of the kernel's source, such as
a parent commit's, made with ``git show <commit>:snappy_tpu_torch/csrc/
decode_blocks_r4.cu``) beside the parent's own build (``kernel_profile``).
K3 overlaps its walk with its drains: one walker warp fills record chunks
while the other warps drain the chunk before.

Lane 0 of the walker warp reads ``clock64()`` around its walk and its waits
for a drained chunk, and lane 0 of the first drain warp around its waits
for a walked chunk, the literal drain (with its barrier), the parallel part
of each copy group and the ordered pass after a flagged one (each with its
barriers); thread 0 times the whole block. Counted too: tags, records, copy
groups and flagged groups.

On batches of 64 KiB blocks encoded by the native encoder (the corpus mix
that ``chip_smoke.py`` decodes, its first 128 blocks, the size of the
bench's batch, and 256 blocks of single corpus files) it prints, after the
card's name and power limit and each kernel's shared memory a block and
blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): K1's,
K3's and the parent's times (CUDA events, median of 5 after a warm-up),
and for K3 and the parent cycles a record by phase and their tallies a
block, from the instrumented copies, whose output must equal K3's. With
``--json`` it writes the records there too. Requires a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_decode, cuda_decode_r4, kernels
from ..utils.metrics import time_device_fn
from . import kernel_profile
from .corpus import BLOCK, FILES, MIX, block_batch, read, repeat_to

# Blocks of the corpus mix (chip_smoke.py's), of its head (bench.py's batch)
# and of each file.
MIX_BLOCKS, BENCH_BLOCKS, FILE_BLOCKS = 1024, 128, 256

_COUNTERS = "__device__ unsigned long long g_prof[16];\nnamespace {\n"
_READ = (
    'extern "C" {\n'
    "int prof_read(unsigned long long* h) { return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
    "int prof_reset() { unsigned long long z[16] = {0}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"
)

# Counter slots, and K3's probes (``kernel_profile``).
PHASES = ["walk", "walker wait", "drainers' wait", "literals", "copy groups", "ordered pass", "total"]
SLOTS = {"walk": 0, "walker wait": 1, "drainers' wait": 2, "literals": 3, "copy groups": 4,
         "ordered pass": 5, "total": 6, "tags": 7, "records": 8, "groups": 9, "flagged groups": 10,
         "blocks": 11}
PROBES = [
    ("namespace {\n", _COUNTERS),
    ("  for (uint32_t k = 0;; ++k) {\n    const uint32_t b = k & 1;\n    Chunk& ch = chunks[b];\n"
     "    if (k >= 2) bar_sync(kEmptyBar + b, kThreads);\n",
     "  long long tw = clock64(), c_walk = 0, c_wait = 0, n_tags = 0;\n"
     "  for (uint32_t k = 0;; ++k) {\n    const uint32_t b = k & 1;\n    Chunk& ch = chunks[b];\n"
     "    c_walk += clock64() - tw;\n    tw = clock64();\n"
     "    if (k >= 2) bar_sync(kEmptyBar + b, kThreads);\n    c_wait += clock64() - tw;\n    tw = clock64();\n"),
    ("          mine = lane == n ? ip : mine;\n", "          mine = lane == n ? ip : mine;\n          ++n_tags;\n"),
    ("      if (k >= 1) bar_sync(kEmptyBar + (b ^ 1), kThreads);\n",
     "      c_walk += clock64() - tw;\n      tw = clock64();\n"
     "      if (k >= 1) bar_sync(kEmptyBar + (b ^ 1), kThreads);\n      c_wait += clock64() - tw;\n"
     "      if (lane == 0) {\n        atomicAdd(&g_prof[0], (unsigned long long)c_walk);\n"
     "        atomicAdd(&g_prof[1], (unsigned long long)c_wait);\n"
     "        atomicAdd(&g_prof[7], (unsigned long long)n_tags);\n      }\n"),
    ("  for (uint32_t k = 0;; ++k) {\n    const uint32_t b = k & 1;\n    const Chunk& ch = chunks[b];\n"
     "    bar_sync(kFullBar + b, kThreads);\n    const uint4 h = ch.head;\n",
     "  long long td = 0, c[4] = {0, 0, 0, 0}, n_rec = 0, n_grp = 0, n_flag = 0;\n"
     "  for (uint32_t k = 0;; ++k) {\n    const uint32_t b = k & 1;\n    const Chunk& ch = chunks[b];\n"
     "    td = clock64();\n    bar_sync(kFullBar + b, kThreads);\n    c[0] += clock64() - td;\n    td = clock64();\n"
     "    const uint4 h = ch.head;\n    n_rec += h.x + h.y;\n"),
    ("      bar_sync(kDrainBar, kDrainThreads);\n      for (uint32_t g = 0; g < h.y; g += kGroup) {\n",
     "      bar_sync(kDrainBar, kDrainThreads);\n      c[1] += clock64() - td;\n      td = clock64();\n"
     "      for (uint32_t g = 0; g < h.y; g += kGroup) {\n        ++n_grp;\n"),
    ("        if (flagged) {\n          bar_sync(kDrainBar, kDrainThreads);\n",
     "        if (flagged) {\n          bar_sync(kDrainBar, kDrainThreads);\n"
     "          c[2] += clock64() - td;\n          td = clock64();\n          ++n_flag;\n"),
    ("        bar_sync(kDrainBar, kDrainThreads);\n      }\n    }\n",
     "        bar_sync(kDrainBar, kDrainThreads);\n        c[flagged ? 3 : 2] += clock64() - td;\n"
     "        td = clock64();\n      }\n    }\n"),
    ("    if ((h.w & kDone) || !(h.w & kOk)) return;\n",
     "    if ((h.w & kDone) || !(h.w & kOk)) {\n      if (dw == 0 && lane == 0) {\n"
     "        for (int i = 0; i < 4; ++i) atomicAdd(&g_prof[2 + i], (unsigned long long)c[i]);\n"
     "        atomicAdd(&g_prof[8], (unsigned long long)n_rec);\n"
     "        atomicAdd(&g_prof[9], (unsigned long long)n_grp);\n"
     "        atomicAdd(&g_prof[10], (unsigned long long)n_flag);\n      }\n      return;\n    }\n"),
    ("  if (warp == 0) {\n    walk(", "  const long long t_begin = clock64();\n  if (warp == 0) {\n    walk("),
    ("    total_out[row] = static_cast<int32_t>(op);\n  }\n}\n",
     "    total_out[row] = static_cast<int32_t>(op);\n"
     "    atomicAdd(&g_prof[6], (unsigned long long)(clock64() - t_begin));\n"
     "    atomicAdd(&g_prof[11], 1ull);\n  }\n}\n"),
    ('extern "C" {\n',
     _READ + "int snappy_cuda_decode_blocks_r4_occupancy(int64_t out_size, int* smem_bytes, int* blocks_per_sm);\n"
     "int prof_occupancy(int64_t, int64_t out_size, int* smem, int* blocks) {\n"
     "  return snappy_cuda_decode_blocks_r4_occupancy(out_size, smem, blocks);\n}\n"),
]


def batches(dev) -> dict:
    """The profiled batches by label: the corpus mix, its first
    BENCH_BLOCKS blocks, and FILE_BLOCKS blocks of each of FILES."""
    files = {n: read(n) for n in MIX}
    mix = repeat_to([files[n] for n in MIX], MIX_BLOCKS * BLOCK)
    raws = {f"corpus mix, {MIX_BLOCKS} blocks": mix, f"corpus mix, first {BENCH_BLOCKS} blocks": mix[: BENCH_BLOCKS * BLOCK]}
    for n in FILES:
        raws[f"{n}, {FILE_BLOCKS} blocks"] = repeat_to([files[n]], FILE_BLOCKS * BLOCK)
    out = {}
    for label, raw in raws.items():
        comp, clens, ulens, out_size = block_batch(raw)
        out[label] = (*(torch.from_numpy(a).to(dev) for a in (comp, clens, ulens)), out_size)
    return out


def tally(counts, blocks: int) -> dict:
    """Per block: the tallies; per record: each phase's cycles."""
    per = {k: counts[i] / blocks for k, i in SLOTS.items() if k != "blocks"}
    records = per["records"] or 1.0
    return {
        "per_block": {k: per[k] for k in SLOTS if k not in PHASES and k != "blocks"},
        "cycles_per_block": per["total"],
        "cycles_per_record": {ph: per[ph] / records for ph in PHASES},
        "walk_cycles_per_tag": per["walk"] / (per["tags"] or 1.0),
    }


def profile(lib: ctypes.CDLL, args, want) -> dict:
    """One launch of an instrumented copy on ``args``: its tallies; its
    output must equal ``want``."""
    kernels.check(lib.prof_reset(), "prof_reset")
    got = kernel_profile.launch_decoder(lib.snappy_cuda_decode_blocks_r4, *args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("the instrumented copy differs from K3")
    counts = (ctypes.c_ulonglong * 16)()
    kernels.check(lib.prof_read(counts), "prof_read")
    return tally(counts, args[0].shape[0])


def occupancy(lib: ctypes.CDLL, row_c: int, out_size: int) -> tuple[int, int]:
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    kernels.check(lib.prof_occupancy(row_c, out_size, ctypes.byref(smem), ctypes.byref(blocks)), "prof_occupancy")
    return smem.value, blocks.value


def line(rec: dict) -> str:
    """One set's record as text."""
    def phases(t):
        cyc = ", ".join(f"{k} {v:.1f}" for k, v in t["cycles_per_record"].items())
        blk = ", ".join(f"{v:.1f} {k}" for k, v in t["per_block"].items())
        return (f"{t['cycles_per_block']:.0f} cycles a block; cycles a record: {cyc}, "
                f"walk {t['walk_cycles_per_tag']:.1f} cycles a tag; per block {blk}")

    times = ", ".join(f"{k} {v:.4f} ms" for k, v in rec["ms"].items())
    text = f"{rec['set']}: {rec['bytes']} compressed bytes; {times}; K3 {phases(rec['K3'])}"
    if "parent" in rec:
        text += f"; parent {phases(rec['parent'])}"
    return text


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_decode_r4")
    ap.add_argument("--parent", help="another copy of decode_blocks_r4.cu, profiled beside it")
    ap.add_argument("--json", help="write the records to this file")
    try:
        args = ap.parse_args(argv)
    except SystemExit:
        return 2
    if not torch.cuda.is_available():
        print("profile_decode_r4: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sources = {"r4_profiled": kernel_profile.instrument((kernels.CSRC / "decode_blocks_r4.cu").read_text(), PROBES)}
    if args.parent:
        parent_src = Path(args.parent).read_text()
        sources["r4_parent_profiled"] = kernel_profile.instrument(parent_src, PROBES)
        sources["r4_parent"] = parent_src
    kernels.load("decode_blocks", "decode_blocks_r4")
    libs = kernel_profile.build("decode_blocks_r4", sources)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sets = batches(dev)
    row_c = next(iter(sets.values()))[0].shape[1]
    occ = {"K1": cuda_decode.occupancy(), "K3": occupancy(libs["r4_profiled"], row_c, BLOCK)}
    if args.parent:
        occ["parent"] = occupancy(libs["r4_parent_profiled"], row_c, BLOCK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("shared memory a block and blocks an SM at 64 KiB rows (C = {row_c}): ".format(row_c=row_c)
          + "; ".join(f"{k} {s} bytes, {b} an SM ({b * sms} at once on {sms} SMs)" for k, (s, b) in occ.items()),
          flush=True)
    fns = {"K1": cuda_decode.decode_blocks, "K3": cuda_decode_r4.decode_blocks}
    if args.parent:
        fns["parent"] = functools.partial(kernel_profile.launch_decoder, libs["r4_parent"].snappy_cuda_decode_blocks_r4)
    records = []
    for label, batch in sets.items():
        want = cuda_decode_r4.decode_blocks(*batch)
        torch.cuda.synchronize()
        if not bool(want[1].all()):
            raise RuntimeError(f"{label}: K3 refused a block")
        if args.parent:
            got = fns["parent"](*batch)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{label}: the parent differs from K3")
        rec = {"set": label, "blocks": batch[0].shape[0], "bytes": int(batch[1].sum()),
               "ms": {k: time_device_fn(fn, batch, iters=5, warmup=1) * 1e3 for k, fn in fns.items()},
               "K3": profile(libs["r4_profiled"], batch, want)}
        if args.parent:
            rec["parent"] = profile(libs["r4_parent_profiled"], batch, want)
        records.append(rec)
        print(line(rec), flush=True)
    result = {"card": card, "occupancy": occ, "sets": records}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    print(json.dumps({"profile_decode_r4": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
