"""Where K3's cycles go, by phase, on one CUDA card, beside another copy of it.

    python -m snappy_tpu_torch.tools.profile_decode_r4 [--parent PATH] [--json PATH]

Builds an instrumented copy of ``csrc/decode_blocks_r4.cu`` into the build
directory, and of ``--parent`` (another copy of the kernel's source, such as
a parent commit's, made with ``git show <commit>:snappy_tpu_torch/csrc/
decode_blocks_r4.cu``) beside the parent's own build. It knows two layouts:
the overlapped one (one walker warp filling record chunks while the other
warps drain the chunk before) and the serial one before it (one thread
walks a chunk while the block waits, then the block drains it).

In the overlapped layout lane 0 of the walker warp reads ``clock64()``
around its walk and its waits for a drained chunk, and lane 0 of the first
drain warp around its waits for a walked chunk, the literal drain (with its
barrier), the parallel part of each copy group and the ordered pass after
a flagged one (each with its barriers); thread 0 times the whole block.
Counted too: tags, records, copy groups and flagged groups. In the serial layout thread 0 reads it around the walk, the
literal drain, each copy group's parallel part and its ordered pass.

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
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..native import runtime as nat
from ..native.build import build_shared
from ..ops import cuda_decode, cuda_decode_r4, kernels
from ..ops.host import pack_rows
from ..utils.metrics import time_device_fn

BLOCK = 1 << 16
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MIX = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]
FILES = ["alice29.txt", "html", "kppkn.gtb", "fireworks.jpeg"]
# Blocks of the corpus mix (chip_smoke.py's), of its head (bench.py's batch)
# and of each file.
MIX_BLOCKS, BENCH_BLOCKS, FILE_BLOCKS = 1024, 128, 256

_COUNTERS = "__device__ unsigned long long g_prof[16];\nnamespace {\n"
_READ = (
    'extern "C" {\n'
    "int prof_read(unsigned long long* h) { return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
    "int prof_reset() { unsigned long long z[16] = {0}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"
)

# Overlapped layout: counter slots, and (text in the kernel source, the same
# text with its counters).
OVERLAPPED_PHASES = ["walk", "walker wait", "drainers' wait", "literals", "copy groups", "ordered pass", "total"]
OVERLAPPED_SLOTS = {"walk": 0, "walker wait": 1, "drainers' wait": 2, "literals": 3, "copy groups": 4,
                    "ordered pass": 5, "total": 6, "tags": 7, "records": 8, "groups": 9, "flagged groups": 10,
                    "blocks": 11}
_OVERLAPPED = [
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

# Serial layout (one thread walks, then the block drains).
SERIAL_PHASES = ["walk", "literals", "copy groups", "ordered pass", "total"]
SERIAL_SLOTS = {"walk": 0, "literals": 1, "copy groups": 2, "ordered pass": 3, "total": 4, "records": 5,
                "groups": 6, "flagged groups": 7}
_SERIAL = [
    ("namespace {\n", _COUNTERS),
    ("  bool more = fits;\n",
     "  long long c[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0 = clock64();\n  const long long t_begin = t0;\n"
     "  bool more = fits;\n"),
    ("    if (tid == 0) walk_chunk(in, clen, ulen, lit_src, lit_op, lit_n, cp_op, cp_f, cp_n, st);\n"
     "    __syncthreads();\n",
     "    t0 = clock64();\n"
     "    if (tid == 0) walk_chunk(in, clen, ulen, lit_src, lit_op, lit_n, cp_op, cp_f, cp_n, st);\n"
     "    __syncthreads();\n    c[0] += clock64() - t0; t0 = clock64();\n"),
    ("    if (!chunk_ok) break;\n", "    if (!chunk_ok) break;\n    c[5] += n_lit + n_cpy;\n"),
    ("      for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = in[s + j];\n    }\n    __syncthreads();\n",
     "      for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = in[s + j];\n    }\n    __syncthreads();\n"
     "    c[1] += clock64() - t0; t0 = clock64();\n"),
    ("      __syncthreads();\n      if (any_after) {",
     "      __syncthreads();\n      c[2] += clock64() - t0; t0 = clock64();\n      ++c[6];\n      c[7] += any_after;\n"
     "      if (any_after) {"),
    ("        __syncthreads();\n      }\n    }\n  }\n  __syncthreads();\n",
     "        __syncthreads();\n      }\n      c[3] += clock64() - t0; t0 = clock64();\n    }\n  }\n"
     "  __syncthreads();\n  c[4] = clock64() - t_begin;\n"
     "  if (tid == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)c[i]);\n"),
    ('extern "C" {\n',
     _READ + "int prof_occupancy(int64_t row_c, int64_t out_size, int* smem_bytes, int* blocks) {\n"
     "  int dev = 0, optin = 0;\n  cudaError_t err = cudaGetDevice(&dev);\n"
     "  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);\n"
     "  if (err != cudaSuccess) return err;\n"
     "  const int64_t both = kHeadBytes + round16(row_c) + round16(out_size), comp_only = kHeadBytes + round16(row_c);\n"
     "  void (*kernel)(const uint8_t*, const int32_t*, const int32_t*, int64_t, int64_t, uint8_t*, uint8_t*,"
     " int32_t*) = decode_blocks_r4_kernel<false, false>;\n"
     "  int64_t smem = kHeadBytes;\n"
     "  if (both <= optin) { kernel = decode_blocks_r4_kernel<true, true>; smem = both; }\n"
     "  else if (comp_only <= optin) { kernel = decode_blocks_r4_kernel<true, false>; smem = comp_only; }\n"
     "  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));\n"
     "  if (err != cudaSuccess) return err;\n  *smem_bytes = int(smem);\n"
     "  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, size_t(smem));\n}\n"),
]

LAYOUTS = {
    "overlapped": (OVERLAPPED_PHASES, OVERLAPPED_SLOTS, _OVERLAPPED),
    "serial": (SERIAL_PHASES, SERIAL_SLOTS, _SERIAL),
}


def layout_of(src: str) -> str:
    return "overlapped" if "bar_arrive(" in src else "serial"


def instrument(src: str) -> tuple[str, str]:
    """(layout, the source with its counters). Raises if an anchor of the
    layout is missing or not unique."""
    layout = layout_of(src)
    for old, new in LAYOUTS[layout][2]:
        if src.count(old) != 1:
            raise RuntimeError(f"the {layout} kernel source does not hold {old!r} exactly once")
        src = src.replace(old, new)
    return layout, src


def _bind(lib: ctypes.CDLL, instrumented: bool) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.snappy_cuda_decode_blocks_r4.argtypes = [p, p, p, i64, i64, i64, p, p, p, p]
    lib.snappy_cuda_decode_blocks_r4.restype = ctypes.c_int
    if instrumented:
        lib.prof_read.argtypes, lib.prof_reset.argtypes = [p], []
        lib.prof_occupancy.argtypes = [i64, i64, p, p]
        lib.prof_read.restype = lib.prof_reset.restype = lib.prof_occupancy.restype = ctypes.c_int
    return lib


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """Build each (name -> CUDA source text) into the build directory, one
    nvcc each, all at once; the libraries by name."""
    out_dir = kernels.CSRC.parent / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = [str(kernels.nvcc_path()), *kernels.NVCC_FLAGS]

    def one(item):
        name, text = item
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        return name, _bind(ctypes.CDLL(str(build_shared(compiler, [path], name))), "prof_read" in text)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def launch(lib: ctypes.CDLL, comp, clens, ulens, out_size: int):
    """(out, ok, total) of ``lib``'s decoder on the card."""
    b, c = comp.shape
    out = torch.empty((b, out_size), dtype=torch.uint8, device=comp.device)
    ok = torch.empty(b, dtype=torch.bool, device=comp.device)
    total = torch.empty(b, dtype=torch.int32, device=comp.device)
    rc = lib.snappy_cuda_decode_blocks_r4(
        comp.data_ptr(), clens.data_ptr(), ulens.data_ptr(), b, c, out_size,
        out.data_ptr(), ok.data_ptr(), total.data_ptr(), torch.cuda.current_stream(comp.device).cuda_stream,
    )
    kernels.check(rc, "decode_blocks_r4 launch")
    return out, ok, total


def block_batch(raw: bytes, dev):
    """The native encoder's streams of the 64 KiB blocks of ``raw`` as the
    block decoders' arguments on ``dev``."""
    n = len(raw) // BLOCK
    buf = np.frombuffer(raw[: n * BLOCK], np.uint8).reshape(n, BLOCK).copy()
    streams = nat.compress_rows(buf, np.full(n, BLOCK, np.int32), np.arange(n))
    clens = np.array([len(s) for s in streams], np.int64)
    comp = pack_rows(np.frombuffer(b"".join(streams), np.uint8), np.concatenate([[0], np.cumsum(clens)[:-1]]), clens)
    return (
        torch.from_numpy(comp).to(dev),
        torch.from_numpy(clens.astype(np.int32)).to(dev),
        torch.full((n,), BLOCK, dtype=torch.int32, device=dev),
        BLOCK,
    )


def repeat_to(data: list[bytes], n: int) -> bytes:
    out, total, i = [], 0, 0
    while total < n:
        out.append(data[i % len(data)])
        total += len(out[-1])
        i += 1
    return b"".join(out)[:n]


def batches(dev) -> dict:
    """The profiled batches by label: the corpus mix, its first
    BENCH_BLOCKS blocks, and FILE_BLOCKS blocks of each of FILES."""
    files = {n: open(os.path.join(REPO, "testdata", n), "rb").read() for n in MIX}
    mix = repeat_to([files[n] for n in MIX], MIX_BLOCKS * BLOCK)
    out = {f"corpus mix, {MIX_BLOCKS} blocks": block_batch(mix, dev),
           f"corpus mix, first {BENCH_BLOCKS} blocks": block_batch(mix[: BENCH_BLOCKS * BLOCK], dev)}
    for n in FILES:
        out[f"{n}, {FILE_BLOCKS} blocks"] = block_batch(repeat_to([files[n]], FILE_BLOCKS * BLOCK), dev)
    return out


def tally(layout: str, counts, blocks: int) -> dict:
    """Per block: the tallies; per record: each phase's cycles."""
    phases, slots, _ = LAYOUTS[layout]
    per = {k: counts[i] / blocks for k, i in slots.items() if k != "blocks"}
    records = per["records"] or 1.0
    return {
        "per_block": {k: per[k] for k in slots if k not in phases and k != "blocks"},
        "cycles_per_block": per["total"],
        "cycles_per_record": {ph: per[ph] / records for ph in phases},
        **({"walk_cycles_per_tag": per["walk"] / (per["tags"] or 1.0)} if "tags" in per else {}),
    }


def profile(lib: ctypes.CDLL, layout: str, args, want) -> dict:
    """One launch of an instrumented copy on ``args``: its tallies; its
    output must equal ``want``."""
    kernels.check(lib.prof_reset(), "prof_reset")
    got = launch(lib, *args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"the instrumented {layout} copy differs from K3")
    counts = (ctypes.c_ulonglong * 16)()
    kernels.check(lib.prof_read(counts), "prof_read")
    return tally(layout, counts, args[0].shape[0])


def occupancy(lib: ctypes.CDLL, row_c: int, out_size: int) -> tuple[int, int]:
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    kernels.check(lib.prof_occupancy(row_c, out_size, ctypes.byref(smem), ctypes.byref(blocks)), "prof_occupancy")
    return smem.value, blocks.value


def line(rec: dict) -> str:
    """One set's record as text."""
    def phases(t):
        cyc = ", ".join(f"{k} {v:.1f}" for k, v in t["cycles_per_record"].items())
        blk = ", ".join(f"{v:.1f} {k}" for k, v in t["per_block"].items())
        tag = f", walk {t['walk_cycles_per_tag']:.1f} cycles a tag" if "walk_cycles_per_tag" in t else ""
        return f"{t['cycles_per_block']:.0f} cycles a block; cycles a record: {cyc}{tag}; per block {blk}"

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
    layout, k3_src = instrument((kernels.CSRC / "decode_blocks_r4.cu").read_text())
    sources = {"r4_profiled": k3_src}
    parent_layout = None
    if args.parent:
        parent_src = Path(args.parent).read_text()
        parent_layout, sources["r4_parent_profiled"] = instrument(parent_src)
        sources["r4_parent"] = parent_src
    kernels.load("decode_blocks", "decode_blocks_r4")
    libs = build(sources)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sets = batches(dev)
    row_c = next(iter(sets.values()))[0].shape[1]
    occ = {"K1": cuda_decode.occupancy(), "K3": occupancy(libs["r4_profiled"], row_c, BLOCK)}
    if parent_layout:
        occ["parent"] = occupancy(libs["r4_parent_profiled"], row_c, BLOCK)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("shared memory a block and blocks an SM at 64 KiB rows (C = {row_c}): ".format(row_c=row_c)
          + "; ".join(f"{k} {s} bytes, {b} an SM ({b * sms} at once on {sms} SMs)" for k, (s, b) in occ.items()),
          flush=True)
    fns = {"K1": cuda_decode.decode_blocks, "K3": cuda_decode_r4.decode_blocks}
    if parent_layout:
        fns["parent"] = lambda *a: launch(libs["r4_parent"], *a)
    records = []
    for label, batch in sets.items():
        want = cuda_decode_r4.decode_blocks(*batch)
        torch.cuda.synchronize()
        if not bool(want[1].all()):
            raise RuntimeError(f"{label}: K3 refused a block")
        if parent_layout:
            got = fns["parent"](*batch)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{label}: the parent differs from K3")
        rec = {"set": label, "blocks": batch[0].shape[0], "bytes": int(batch[1].sum()),
               "ms": {k: time_device_fn(fn, batch, iters=5, warmup=1) * 1e3 for k, fn in fns.items()},
               "K3": profile(libs["r4_profiled"], layout, batch, want)}
        if parent_layout:
            rec["parent"] = profile(libs["r4_parent_profiled"], parent_layout, batch, want)
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
