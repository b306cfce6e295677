"""Where K2's cycles go, by phase, on one CUDA card.

    python -m snappy_tpu_torch.tools.profile_encode [--source PATH]

Builds an instrumented copy of ``csrc/encode_blocks.cu`` (or of another copy
of the encoder at PATH, such as a parent commit's) into the build directory
(``kernel_profile``): thread 0 of each block reads ``clock64()`` where each
phase starts (stage, hash chain, candidates, the chase, the drains, the
tail and zeroing), counts the takes it parses, and adds its totals to
device counters. Then, on batches of 64 KiB and of 32 KiB blocks (the
encoder's two variants, picked by the row width), it prints the kernel's
time (CUDA events, median of 5 after a warm-up; the instrumented source's
own build), the variant's shared memory a block and blocks an SM (this
package's encoder, ``cuda_encode.occupancy``), and, from the instrumented
copy, whose output must equal the plain version's on sampled rows and the
uninstrumented kernel's on all, cycles a block by phase, takes a block
and cycles a take. The 64 KiB batches: the device
rows of ``chip_smoke.py``'s 64 MiB corpus mix (the blocks routing leaves
on the card), 256 blocks of each of alice29.txt, html, kppkn.gtb and
fireworks.jpeg, and one and 132 blocks whose 4-byte keys at every 4th
position are distinct and share one 14-bit hash, the encoder's worst case
(with whether routing would send such a block to the host). The 32 KiB
batches: the corpus mix cut to 32 KiB (its device rows), 2048 blocks of
the benchmark's TPC-H ``lineitem`` rows (``perfbench/data/lineitem.py``,
where the checkout has it), and one and 264 collision blocks whose keys
share one 13-bit hash. The counts include each phase's barrier waits. The
card's name and power limit come first, a ``{"profile_encode": [...]}``
line last. Requires a CUDA card and nvcc; ``measure`` and the batches also
run on the CPU, through the plain version, without cycles.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_encode, encode_torch, kernels, route
from ..ops.host import blockify
from ..utils.metrics import time_device_fn
from . import kernel_profile
from .corpus import BLOCK, FILES, MIX, REPO, read, repeat_to

MIN_PROFIT = 2
# The encoder's hash: the top bits of key * HASH_MUL, mod 2**32, two fewer
# than a position of the variant's blocks has.
HASH_MUL = 0x1E35A7BD


def hash_bits(block_bits: int = 16) -> int:
    """The hash's width in the variant for blocks of 2**block_bits bytes."""
    return block_bits - 2

PHASES = ["stage", "chain", "candidates", "chase", "drains", "tail"]
TOTAL, TAKES = 6, 7

_COUNTERS = "__device__ unsigned long long g_prof[8];\n"
_MARK = (
    "#define PROF_MARK(k) do { const long long prof_now = clock64(); prof_c[prof_phase] += prof_now - prof_t; "
    "prof_t = prof_now; prof_phase = (k); } while (0)\n"
)
_BEGIN = "  long long prof_c[8] = {0, 0, 0, 0, 0, 0, 0, 0}, prof_t = clock64();\n  const long long prof_begin = prof_t;\n  int prof_phase = 0;\n"
_END = (
    "  PROF_MARK(0);\n  prof_c[6] = clock64() - prof_begin;\n"
    "  if (tid == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof_c[i]);\n"
)
_READ = (
    'extern "C" {\nint prof_read(unsigned long long* h) { return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n'
    "int prof_reset() { unsigned long long z[8] = {0}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"
)
# K2's probes (``kernel_profile``).
PROBES = [
    ("namespace {\n", _COUNTERS + _MARK + "namespace {\n"),
    ("  const uint8_t* src = blocks + from;\n", "  const uint8_t* src = blocks + from;\n" + _BEGIN),
    ("  // 2. Hash chain", "  PROF_MARK(1);\n  // 2. Hash chain"),
    ("  // 3. Candidates", "  PROF_MARK(2);\n  // 3. Candidates"),
    ('extern "C" {\n', _READ),
    ("    // 4a. The chase", "    PROF_MARK(3);\n    // 4a. The chase"),
    ("    // 4b. The drain", "    PROF_MARK(4);\n    // 4b. The drain"),
    ("        rec[n++].x = ", "        ++prof_c[7];\n        rec[n++].x = "),
    ("  // 5. The tail literal", "  PROF_MARK(5);\n  // 5. The tail literal"),
    ("  for (int64_t i = end + tid; i < out_w; i += kThreads) dst[i] = 0;\n}\n",
     "  for (int64_t i = end + tid; i < out_w; i += kThreads) dst[i] = 0;\n" + _END + "}\n"),
]


def launch(lib: ctypes.CDLL, blocks: torch.Tensor, blens: torch.Tensor, min_profit: int = MIN_PROFIT):
    """(out, olens) of the encoder library ``lib`` on a CUDA batch."""
    b, w = blocks.shape
    out = torch.empty((b, encode_torch.BLOCK_MAX_OUT), dtype=torch.uint8, device=blocks.device)
    olens = torch.empty(b, dtype=torch.int32, device=blocks.device)
    rc = lib.snappy_cuda_encode_blocks(
        blocks.data_ptr(), blens.data_ptr(), b, w, encode_torch.BLOCK_MAX_OUT, min_profit,
        out.data_ptr(), olens.data_ptr(), torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    kernels.check(rc, "profiled encode_blocks launch")
    return out, olens


def collision_block(n: int = BLOCK, seed: int = 0, hash_value: int = 0x155, bits: int = 14) -> bytes:
    """n bytes whose 4-byte keys at every 4th position are distinct and
    share one hash of ``bits`` bits (``hash_bits`` of the variant): every
    such position's chain holds all the earlier ones, so the candidate pass
    walks ~n²/32 chain steps. Each key is hash_value's top bits over
    distinct random low bits, times the inverse of the hash multiplier;
    none is the sentinel 0xFFFFFFFF, whose 14-bit hash is 0x3872 (0x1C39 in
    13 bits)."""
    inv = pow(HASH_MUL, -1, 1 << 32)
    rng = np.random.default_rng(seed)
    k = -(-n // 4)
    low = rng.choice(1 << (32 - bits), size=k, replace=False).astype(np.uint64)
    y = (np.uint64(hash_value) << np.uint64(32 - bits)) | low
    keys = (y * np.uint64(inv)) & np.uint64(0xFFFFFFFF)
    return keys.astype("<u4").tobytes()[:n]


def record_chunk(block_bits: int = 16, source: Path = kernels.CSRC / "encode_blocks.cu") -> int:
    """Records of one chunk of the chase in the variant for blocks of
    2**block_bits bytes, as the encoder source states it."""
    return int(re.search(rf"struct Knobs<{block_bits}> {{[^}}]*kChunk = (\d+);", source.read_text()).group(1))


def exact_matches(length: int, far: bool) -> bytes:
    """Random bytes, then 24 copies of earlier runs that match for exactly
    ``length`` bytes (the byte after each differs), each after a random
    literal, at distances below 2048 or at 2048 and above."""
    rng = np.random.default_rng(10 * length + far)
    data = bytearray(rng.integers(0, 256, 3000 if far else 500, dtype=np.uint8).tobytes())
    for _ in range(24):
        s = int(rng.integers(0, 400))
        piece = bytearray(data[s : s + length + 1])
        piece[-1] ^= 0xFF
        data += piece + rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
    return bytes(data)


def literals_across_chunks(block: int = BLOCK) -> bytes:
    """More than two chunks of takes, each after a literal of 1 to 257
    bytes, so that chunks start and end inside literal runs of every tag
    size; then a long tail literal: under ``block`` bytes."""
    rng = np.random.default_rng(12)
    data = bytearray(rng.integers(0, 256, 256, dtype=np.uint8).tobytes())
    while len(data) < block - 5536:
        n = int(rng.choice([1, 2, 5, 20, 59, 60, 61, 256, 257], p=[0.2, 0.2, 0.2, 0.15] + [0.05] * 5))
        data += rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        s = int(rng.integers(0, len(data) - 40))
        data += data[s : s + int(rng.integers(4, 40))]
    return bytes(data) + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()


def match_cut_at_the_row_end() -> bytes:
    """40 random bytes, then their first 30 again: a match at 40 that runs
    to the row's end, cut there at 30 bytes, although the bytes read past
    the row (zero) still equal the source's next one (byte 30, zero)."""
    rng = np.random.default_rng(13)
    z = bytearray(rng.integers(1, 256, 40, dtype=np.uint8).tobytes())
    z[30] = 0
    return bytes(z + z[:30])


def takes_exactly(k: int) -> bytes:
    """16 random bytes, then k times 4 fresh random bytes and a copy of the
    first 12: k takes, the last at the row's end."""
    rng = np.random.default_rng(k)
    head = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    return head + b"".join(rng.integers(0, 256, 4, dtype=np.uint8).tobytes() + head[:12] for _ in range(k))


def chase_rows(block_bits: int = 16) -> dict[str, bytes]:
    """Rows that exercise the chase of the encoder's variant for blocks of
    2**block_bits bytes: more takes than its record chunk, matches of
    exactly 7, 8 and 9 bytes near and far, whole-block runs (a capped
    length extended to the row's end), a match cut at the row's end inside
    an 8-byte compare, literals across chunk boundaries, chunks that end
    exactly full, and keys that collide in its hash. Named by the block's
    size (``64k``, ``32k``) where it fills one."""
    block, chunk, size = 1 << block_bits, record_chunk(block_bits), f"{1 << (block_bits - 10)}k"
    return {
        "text-more-takes-than-a-chunk": read("alice29.txt")[:block],
        f"html-{size}": read("html")[:block],
        **{f"match-{n}-{'far' if far else 'near'}": exact_matches(n, far) for n in (7, 8, 9) for far in (False, True)},
        f"rle-{size}": b"q" * block,
        f"zeros-{size}": b"\x00" * block,
        f"period-3-{size}": (b"abc" * (block // 3 + 1))[:block],
        "match-cut-at-the-row-end": match_cut_at_the_row_end(),
        "literals-across-chunks": literals_across_chunks(block),
        **{f"{k}-chunks-exactly-full": takes_exactly(k * chunk) for k in (1, 2)},
        "collision-16k": collision_block(16384, bits=hash_bits(block_bits)),
    }


def variant_bits(n: int) -> int:
    """The variant the launcher picks for blocks of n bytes: 15 (32 KiB)
    or 16 (64 KiB)."""
    return 15 if n <= 1 << 15 else 16


def _mix(mix_blocks: int, n: int, label: str = "corpus mix") -> dict:
    """The device rows of the corpus mix in blocks of n bytes."""
    files = [read(name) for name in MIX]
    buf, blens = blockify(np.frombuffer(repeat_to(files, mix_blocks * n), np.uint8), n)
    dev = np.setdiff1d(np.arange(len(blens)), route.host_blocks(buf, blens))
    return {f"{label}, {len(dev)} device blocks of {len(blens)}": (buf[dev], blens[dev])}


def _collisions(collision_rows, n: int, label: str = "collision") -> dict:
    """Batches of collision blocks of n bytes, whose keys share one hash of
    the variant that takes them."""
    one = np.frombuffer(collision_block(n, bits=hash_bits(variant_bits(n))), np.uint8)
    return {f"{label}, {rows} blocks": blockify(np.tile(one, rows), n) for rows in collision_rows}


def batches(mix_blocks: int = 1024, file_blocks: int = 256, collision_rows=(1, 132), n: int = BLOCK) -> dict:
    """{label: (blocks uint8[B, n + ENC_PAD], blens int32[B])}: the device
    rows of the corpus mix, ``file_blocks`` blocks of each file, and the
    collision rows."""
    out = _mix(mix_blocks, n)
    for name in FILES:
        data = read(name)
        out[f"{name}, {file_blocks} blocks"] = blockify(np.frombuffer(repeat_to([data], file_blocks * n), np.uint8), n)
    return {**out, **_collisions(collision_rows, n)}


def lineitem_rows(blocks: int, n: int, device=None) -> np.ndarray | None:
    """``blocks`` blocks of n bytes of the benchmark's shuffle rows (TPC-H
    ``lineitem`` as Spark serializes them), drawn on ``device`` by
    ``perfbench/data/lineitem.py`` from its configuration's table seed; None
    where the checkout has no benchmark."""
    gen, conf = REPO / "perfbench" / "data" / "lineitem.py", REPO / "perfbench" / "configs" / "shuffle_32k.json"
    if not (gen.is_file() and conf.is_file()):
        return None
    spec = importlib.util.spec_from_file_location("profile_encode_lineitem", gen)
    lineitem = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lineitem)
    config = {**json.loads(conf.read_text()), "block_size": n, "blocks_per_batch": blocks, "resident_batches": 1}
    table = lineitem.table(config, torch.device("cpu") if device is None else device)
    return table.cpu().numpy().reshape(-1)


def narrow_batches(mix_blocks: int = 2048, lineitem_blocks: int = 2048, collision_rows=(1, 264),
                   n: int = 1 << 15, device=None) -> dict:
    """The batches of the 32 KiB variant, as ``batches``: the device rows of
    the corpus mix cut to n bytes, ``lineitem_blocks`` blocks of the shuffle
    rows (where the checkout has them), and the collision rows."""
    size = f"{n // 1024} KiB"
    out = _mix(mix_blocks, n, f"corpus mix cut to {size}")
    rows = lineitem_rows(lineitem_blocks, n, device)
    if rows is not None:
        out[f"lineitem, {lineitem_blocks} blocks of {size}"] = blockify(rows, n)
    return {**out, **_collisions(collision_rows, n, f"collision of {size}")}


def measure(label: str, blocks: np.ndarray, blens: np.ndarray, dev, libs=None, check_rows: int = 4) -> dict:
    """One batch's record: the kernel's time (``cuda_encode.encode_blocks``;
    its plain version on the CPU) and, with ``libs`` = (instrumented,
    uninstrumented library) on the card, the uninstrumented source's
    time, its cycles a block by phase, takes a block and cycles a take. The
    instrumented output must equal the kernel's, and both the plain
    version's on ``check_rows`` sampled rows."""
    b = len(blens)
    args = (torch.from_numpy(blocks).to(dev), torch.from_numpy(blens).to(dev), MIN_PROFIT)
    iters = 5 if dev.type == "cuda" else 1
    rec = {"set": label, "blocks": b, "bytes": int(blens.sum()),
           "ms": time_device_fn(cuda_encode.encode_blocks, args, iters=iters, warmup=1) * 1e3,
           "routed_to_host": int(len(route.host_blocks(blocks[:1], blens[:1]))) if label.startswith("collision") else None}
    want = cuda_encode.encode_blocks(*args)
    pick = np.unique(np.linspace(0, b - 1, min(check_rows, b)).astype(np.int64))
    plain = encode_torch.encode_blocks(args[0][pick].cpu(), args[1][pick].cpu(), MIN_PROFIT)
    if not (torch.equal(want[0][pick].cpu(), plain[0]) and torch.equal(want[1][pick].cpu(), plain[1])):
        raise RuntimeError(f"{label}: the encoder differs from its plain version")
    rec["out_bytes"] = int(want[1].sum())
    rec["variant_bits"] = variant_bits(blocks.shape[1] - encode_torch.ENC_PAD)
    if libs is None:
        return rec
    rec["smem_bytes"], rec["blocks_per_sm"] = cuda_encode.occupancy(blocks.shape[1])
    probed, timed = libs
    rec["source_ms"] = time_device_fn(lambda *a: launch(timed, *a), args[:2], iters=iters, warmup=1) * 1e3
    probed.prof_reset()
    got = launch(probed, *args[:2])
    torch.cuda.synchronize()
    again = launch(timed, *args[:2])
    if not all(torch.equal(x, y) for x, y in zip((*got, *again), (*want, *want))):
        raise RuntimeError(f"{label}: the source's kernel differs from the encoder")
    counts = (ctypes.c_ulonglong * 8)()
    probed.prof_read(counts)
    per = [c / b for c in counts]
    rec["cycles_per_block"] = per[TOTAL]
    rec["phases"] = dict(zip(PHASES, per[:TOTAL]))
    rec["takes_per_block"] = takes = per[TAKES]
    rec["chase_cycles_per_take"] = per[3] / takes if takes else None
    rec["chase_and_drain_cycles_per_take"] = (per[3] + per[4]) / takes if takes else None
    return rec


def line(r: dict) -> str:
    s = f"{r['set']}: {r['bytes']} bytes -> {r['out_bytes']}; kernel {r['ms']:.4f} ms"
    if r.get("routed_to_host") is not None:
        s += f"; routing would send a block to the host: {bool(r['routed_to_host'])}"
    if "phases" not in r:
        return s
    total = r["cycles_per_block"]
    shares = ", ".join(f"{k} {v:.0f} ({v / total:.1%})" for k, v in r["phases"].items())
    s = (f"{s}; source {r['source_ms']:.4f} ms; the {1 << (r['variant_bits'] - 10)} KiB variant, "
         f"{r['smem_bytes']} B a block, {r['blocks_per_sm']} an SM; cycles a block {total:.0f}: {shares}; ")
    if not r["takes_per_block"]:
        return s + "no takes"
    return (f"{s}{r['takes_per_block']:.1f} takes a block, {r['chase_cycles_per_take']:.1f} cycles a take in the "
            f"chase, {r['chase_and_drain_cycles_per_take']:.1f} with the drains")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_encode")
    ap.add_argument("--source", type=Path, default=kernels.CSRC / "encode_blocks.cu",
                    help="the encoder source to instrument (default: this package's)")
    try:
        opts = ap.parse_args(argv)
    except SystemExit:
        return 2
    if not torch.cuda.is_available():
        print("profile_encode: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    text = opts.source.read_text()
    built = kernel_profile.build("encode_blocks", {
        "encode_profiled": kernel_profile.instrument(text, PROBES), "encode_timed": text,
    })
    libs = built["encode_profiled"], built["encode_timed"]
    print(f"source {os.path.relpath(opts.source, REPO)}", flush=True)
    records = []
    for label, (blocks, blens) in {**batches(), **narrow_batches(device=dev)}.items():
        records.append(measure(label, blocks, blens, dev, libs))
        print(line(records[-1]), flush=True)
    print(json.dumps({"profile_encode": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
