"""Where K1's cycles go, by phase, on one CUDA card.

    python -m snappy_tpu_torch.tools.profile_decode [--source PATH] [--window BYTES] [--ring BYTES]

Builds an instrumented copy of ``csrc/decode_blocks.cu`` (or of another
copy of the windowed decoder at PATH, such as a parent commit's) into the
build directory (``kernel_profile``). Each thread of a block reads
``clock64()`` around each phase: staging compressed bytes in shared memory,
literal moves, near and far copy moves, window flushes, the tail (the last
flush and the zeros past the output), building the ring's step tables, and
the chase (the positions of a batch's tags from the tables); the walk (the
lanes' reads of their tags, the scan and the checks) is the rest of the
block's cycles. Thread 0 counts tags, literals, near and far copies,
stagings, the tables' builds, the chase's batches and the tags it placed
from the four-tag table and one at a time, and adds its totals to device
counters. A copy is near when its offset is at most the window's reach
(window less 64 bytes).

Then, on batches of blocks encoded by the native encoder (the corpus mix
that ``chip_smoke.py`` decodes in 64 KiB blocks, 2,048 blocks of 32 KiB of
the benchmark's shuffle rows, and 256 blocks each of alice29.txt, html,
kppkn.gtb and fireworks.jpeg), it prints the kernel's time (CUDA
events, median of 5 after a warm-up: this package's kernel, the source's
own uninstrumented build and the instrumented one) and, from the
instrumented copy, whose output must equal the uninstrumented build's on
all rows and the plain version's on sampled rows: cycles a block by phase,
its counts a block, cycles a tag, the share of tags the tables placed, tags
a batch, the chase's cycles a tag it placed, and the
shared memory a block and blocks resident per SM at the launch's size
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). ``--window`` and
``--ring`` build the source with another window or ring (bytes).
The card's name and power limit come first, a ``{"profile_decode": [...]}``
line last. Requires a CUDA card and nvcc; ``measure`` and the batches also
run on the CPU, through the plain version, without cycles.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..core import varint
from ..native import runtime as nat
from ..ops import cuda_decode, decode_torch, kernels
from ..utils.metrics import time_device_fn
from . import kernel_profile, profile_encode
from .corpus import BLOCK, FILES, MIX, REPO, block_batch, read, repeat_to

# Counter slots: the timed phases, the block's total, then the counts. The
# walk is the total less the timed phases.
PHASES = ["stage", "literals", "near copies", "far copies", "flushes", "tail", "tables", "chase"]
TOTAL = len(PHASES)
COUNTS = ["tags", "literals", "near copies", "far copies", "stagings", "table tags", "single tags", "batches",
          "table builds"]
SLOTS = TOTAL + 1 + len(COUNTS)
NEAR_MARGIN = 64  # a near copy's offset is at most the window less this

_COUNTERS = f"__device__ unsigned long long g_prof[{SLOTS}];\n"
_MACROS = (
    "#define PROF_T0 (prof_t = clock64())\n"
    "#define PROF_ADD(k) (prof_c[k] += clock64() - prof_t)\n"
)
_BEGIN = (
    f"  long long prof_c[{SLOTS}] = {{0}}, prof_t = clock64();\n"
    "  const long long prof_begin = prof_t;\n"
)
_END = (
    f"  prof_c[{TOTAL}] = clock64() - prof_begin;\n"
    "  if (threadIdx.x == 0) {\n"
    f"#pragma unroll\n    for (int i = 0; i < {SLOTS}; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof_c[i]);\n"
    "  }\n"
)
_READ = (
    'extern "C" {\n'
    "int prof_read(unsigned long long* h) { return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n"
    f"int prof_reset() {{ unsigned long long z[{SLOTS}] = {{0}}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }}\n"
)
_EXTERN_END = '}  // extern "C"\n'
_TAG, _LIT, _NEAR, _FAR, _STAGE, _TABLE, _SINGLE, _BATCH, _BUILD = (TOTAL + 1 + i for i in range(len(COUNTS)))


def probes(window: int | None = None) -> list[tuple]:
    """K1's probes (``kernel_profile``): its ring stagings (three call
    sites), the moves (each ends at the warp sync after it; a literal moved
    alone spans its pieces, the flushes between them included), the flushes
    of full halves, the tail, the tables' builds and the chase, with the
    chase's batches and the tags it placed by the four-tag table (the tags
    between filled in) and one at a time. The walk is the rest: the lanes'
    reads of their tags, the scan and the checks. A copy is near when its
    offset is at most ``window`` (default: this package's) less 64 bytes."""
    near = (window or window_bytes()) - NEAR_MARGIN
    occupancy = (
        "int prof_occupancy(int64_t, int64_t, int* smem, int* blocks) {\n"
        "  return snappy_cuda_decode_blocks_occupancy(smem, blocks);\n"
        "}\n"
    )
    # A staging inside a literal's span is taken out of it: its start moves by
    # the staging's cycles.
    stage = (
        "#define PROF_STAGE(...) do { const long long prof_s = clock64(); stage(__VA_ARGS__); "
        "const long long prof_e = clock64(); prof_c[0] += prof_e - prof_s; prof_t += prof_e - prof_s; "
        f"++prof_c[{_STAGE}]; }} while (0)\n"
    )
    move_end = "      // Lanes read bytes other lanes wrote for earlier tags.\n"
    flush_end = "        flushed += kHalf;\n        __syncwarp();\n      }\n    }\n  }\n"
    begin_after = "  uint8_t* dst = out + row * out_size;\n"
    build = "        chart(st, ring, advance, ip - rbase, rbase, rend, clen, lane);\n"
    chase_end = "      }\n    }\n    uint32_t c = 0, word = 0;  // a tag byte and the 4 bytes after it\n"
    return [
        ("namespace {\n", _COUNTERS + _MACROS + "namespace {\n"),
        (begin_after, begin_after + _BEGIN + "  int prof_k = 0;\n  uint32_t prof_n4 = 0;\n"),
        ('extern "C" {\n', _READ),
        ("namespace {\n", stage + "namespace {\n"),
        ("stage(ring, src, ", "PROF_STAGE(ring, src, ", 3),
        (build, f"        PROF_T0;\n{build}        PROF_ADD(6);\n        ++prof_c[{_BUILD}];\n"),
        ("    uint32_t at = 0, nb = 0;\n", "    PROF_T0;\n    uint32_t at = 0, nb = 0;\n"),
        ("      at = __shfl_sync(0xFFFFFFFFu, at4, lane >> 2);\n",
         "      prof_n4 = nb;\n      at = __shfl_sync(0xFFFFFFFFu, at4, lane >> 2);\n"),
        (chase_end,
         f"      }}\n      prof_c[{_TABLE}] += prof_n4;\n      prof_c[{_SINGLE}] += nb - prof_n4;\n"
         f"      prof_c[{_BATCH}] += nb > 0;\n    }}\n    PROF_ADD(7);\n"
         "    uint32_t c = 0, word = 0;  // a tag byte and the 4 bytes after it\n"),
        ("      // A literal with a length trailer or past the ring, alone.\n",
         f"      ++prof_c[{_TAG}];\n      ++prof_c[{_LIT}];\n      // A literal with a length trailer or past the ring, alone.\n"),
        ("      for (;;) {\n", "      PROF_T0;\n      for (;;) {\n"),
        ("      continue;\n", "      PROF_ADD(1);\n      continue;\n"),
        ("      const uint4 r = next_rec;\n",
         "      const uint4 r = next_rec;\n      PROF_T0;\n"
         "      prof_k = (r.y & 0x100u) ? 1 : r.z <= kNear ? 2 : 3;\n"
         f"      ++prof_c[{_TAG}];\n      prof_c[{_LIT}] += prof_k == 1;\n"
         f"      prof_c[{_NEAR}] += prof_k == 2;\n      prof_c[{_FAR}] += prof_k == 3;\n"),
        (move_end,
         "      {\n        const long long prof_d = clock64() - prof_t;\n"
         "        prof_c[1] += prof_k == 1 ? prof_d : 0;\n        prof_c[2] += prof_k == 2 ? prof_d : 0;\n"
         "        prof_c[3] += prof_k == 3 ? prof_d : 0;\n      }\n" + move_end),
        ("        // A full half goes to the row, where far copies read it.\n",
         "        PROF_T0;\n        // A full half goes to the row, where far copies read it.\n"),
        (flush_end, "        flushed += kHalf;\n        __syncwarp();\n        PROF_ADD(4);\n      }\n    }\n  }\n"),
        ("  // Tail: ", "  PROF_T0;\n  // Tail: "),
        ("    total_out[row] = static_cast<int32_t>(op);\n  }\n}\n",
         "    total_out[row] = static_cast<int32_t>(op);\n  }\n  PROF_ADD(5);\n" + _END + "}\n"),
        (_EXTERN_END, occupancy + _EXTERN_END),
    ]


def window_bytes(src: str | None = None) -> int:
    """The window a decoder source keeps by default (this package's)."""
    src = (kernels.CSRC / "decode_blocks.cu").read_text() if src is None else src
    return int(re.search(r"#define SNAPPY_K1_WINDOW (\d+)", src).group(1))


def ring_bytes(src: str | None = None) -> int:
    """The compressed bytes a decoder source stages at a time."""
    src = (kernels.CSRC / "decode_blocks.cu").read_text() if src is None else src
    return int(re.search(r"#define SNAPPY_K1_RING (\d+)", src).group(1))


class _Stream:
    """A tag stream built tag by tag, with the output it decodes to."""

    def __init__(self):
        self.body, self.out = bytearray(), bytearray()

    def literal(self, data: bytes) -> None:
        n = len(data) - 1
        if n < 60:
            self.body += bytes([n << 2]) + data
        else:
            k = (n.bit_length() + 7) // 8
            self.body += bytes([(59 + k) << 2]) + n.to_bytes(k, "little") + data
        self.out += data

    def copy(self, length: int, offset: int, four: bool = False, one: bool = False) -> None:
        """A COPY_2, a COPY_1 where ``one`` (length 4-11, offset under
        2048), or a COPY_4 where ``four`` or the offset needs it."""
        if one:
            self.body += bytes([0x01 | (length - 4) << 2 | (offset >> 8) << 5, offset & 0xFF])
        elif offset < 1 << 16 and not four:
            self.body += bytes([0x02 | (length - 1) << 2]) + offset.to_bytes(2, "little")
        else:
            self.body += bytes([0x03 | (length - 1) << 2]) + offset.to_bytes(4, "little")
        for _ in range(length):
            self.out.append(self.out[-offset])

    def advance(self, n: int, offset: int, rng) -> None:
        """n more output bytes: copies of 64 from ``offset`` back, then one
        shorter copy, or a literal for the last 1-3 bytes."""
        while n > 64:
            step = 64 if n >= 68 else n - 4  # leave 4 or more for the last copy
            self.copy(step, offset)
            n -= step
        if n >= 4:
            self.copy(n, offset)
        elif n:
            self.literal(rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    def fill_to(self, at: int, rng) -> None:
        """Short literals (60 bytes or fewer, none of one byte) until the
        stream is ``at`` bytes long; ``at`` is 0 or 2 or more bytes on."""
        while len(self.body) < at:
            left = at - len(self.body)
            take = left if left <= 61 else 60 if left == 62 else 61
            self.literal(rng.integers(0, 256, take - 1, dtype=np.uint8).tobytes())

    def row(self) -> tuple[bytes, bytes]:
        return bytes(self.body), bytes(self.out)


def window_rows(window: int | None = None, ring: int | None = None) -> dict[str, tuple[bytes, bytes]]:
    """{name: (tag stream, the bytes it decodes to)}: rows at the edges of
    the decoder's output window and compressed ring (default: this
    package's), none longer than 128 KiB of output for a window up to 16
    KiB. Copies from offsets around the window and its near reach (window
    less 64 bytes), each across a flush of a half window; overlapping
    copies with offsets 1-33 and every length up to 64; literals of about
    the ring's size and of one to three rings; 5-byte COPY_4 tags, some
    after short literals, across the ring's end at every alignment; a 128 KiB segment of text, and text
    across several flushes."""
    window = window or window_bytes()
    ring = ring or ring_bytes()
    half = window // 2
    rng = np.random.default_rng(20)
    rows = {}
    edge = _Stream()
    edge.literal(rng.integers(0, 256, window + 300, dtype=np.uint8).tobytes())
    for off in (window - 65, window - 64, window - 63, window - 1, window, window + 1):
        # Up to 10 bytes before the next flush, then a copy across it.
        edge.advance((-len(edge.out) - 10) % half, off, rng)
        edge.copy(64, off)
        edge.copy(33, off)
    rows["copies-at-the-window-edge"] = edge.row()
    over = _Stream()
    over.literal(rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
    for f in range(1, 34):
        for length in range(1, 65):
            over.copy(length, f)
    rows["overlapping-copies"] = over.row()
    lits = _Stream()
    for n in (20, ring - 32, ring - 31, ring + 100, 3 * ring + 7, 5):
        lits.literal(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        lits.copy(64, 10)
    rows["literals-around-the-ring"] = lits.row()
    wide = _Stream()
    wide.literal(rng.integers(0, 256, 100, dtype=np.uint8).tobytes())
    for k in range(1500):
        if k % 3 == 0:
            wide.literal(rng.integers(0, 256, 1 + k % 7, dtype=np.uint8).tobytes())
        wide.copy(4 + k % 61, 1 + k % 100, four=True)
    rows["copy4-across-the-ring"] = wide.row()
    text = read("alice29.txt")
    for name, raw in (("segment-128k", text[: 2 * BLOCK]), ("text-across-flushes", text[: 3 * window + 1000])):
        stream = nat.compress(raw)
        _, head = varint.parse32(np.frombuffer(stream, np.uint8), 0)
        rows[name] = (stream[head:], raw)
    return rows


def chase_rows(ring: int | None = None) -> dict[str, tuple[bytes, bytes]]:
    """{name: (tag stream, the bytes it decodes to)}: rows at the edges of
    the chase's step tables over the decoder's ring (default: this
    package's), which end a batch where a tag is a literal with a length
    trailer or past the ring, has fewer than 5 bytes of the ring, or is the
    stream's last. A literal with a trailer as the 1st to 34th tag after
    one, so that it cuts four-tag steps at every point and falls 1st, 5th and
    32nd in a batch; the first ring's end at offsets -5 to 0 from the 5 bytes
    after a COPY_1, a COPY_2, a COPY_4 and a literal; short literals that
    end at the first ring's end or a byte past it; 32 and 33 tags that end
    there (where the ring holds them); overlapping copies of offset 1-4 as
    the first tags of batches after full ones; and streams whose last tag is
    two bytes, a COPY_1 or a literal, from the stream's last byte but one."""
    ring = ring or ring_bytes()
    rng = np.random.default_rng(25)

    def noise(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def finish(st):
        # More tags past the first ring's end, so that the walk goes on.
        for k in range(40):
            st.copy(4 + k % 8, 1 + k % 16, one=k % 3 == 0)
            if k % 5 == 0:
                st.literal(noise(1 + k % 9))
        return st.row()

    rows = {}
    cut = _Stream()
    cut.literal(noise(16))
    for k in range(34):
        for j in range(k):
            cut.copy(4 + j % 8, 1 + j % 16, one=j % 2 == 0)
        cut.literal(noise(61 + k))
    rows["trailer-literal-at-every-tag"] = cut.row()
    kinds = {
        "copy1": lambda st: st.copy(4, 3, one=True),
        "copy2": lambda st: st.copy(9, 7),
        "copy4": lambda st: st.copy(5, 2, four=True),
        "literal": lambda st: st.literal(noise(3)),
    }
    for name, emit in kinds.items():
        for off in range(6):
            st = _Stream()
            st.literal(noise(16))
            st.fill_to(ring - 5 + off - 3 * 7, rng)
            for _ in range(7):
                st.copy(5, 16)
            emit(st)
            rows[f"{name}-at-ring-end-less-{5 - off}"] = finish(st)
    for n in (4, 33, 60):
        for past in (0, 1):
            st = _Stream()
            st.literal(noise(16))
            st.fill_to(ring + past - 1 - n, rng)
            st.literal(noise(n))
            rows[f"literal-of-{n}-to-ring-end-plus-{past}"] = finish(st)
    for m in (32, 33):
        st = _Stream()
        size = min(max(ring // m, 5), 61)
        sizes, rest = [size] * m, ring - size * m
        if size < 61 and 0 < rest < m:
            sizes[:rest] = [size + 1] * rest
        elif rest >= 2:
            st.fill_to(rest, rng)
        for n in sizes:
            st.literal(noise(n - 1))
        rows[f"{m}-tags-to-ring-end"] = finish(st)
    rle = _Stream()
    rle.literal(noise(8))
    for _ in range(31):
        rle.copy(8, 8)
    for rep in range(6):
        for f in range(1, 5):
            for length in (4, 9, 64):
                rle.copy(length, f, one=length < 12 and rep % 2 == 0)
        for _ in range(20):
            rle.copy(6, 5 + rep)
    rows["overlapping-copies-after-full-batches"] = rle.row()
    for name, last in (("copy1", lambda st: st.copy(7, 5, one=True)), ("literal", lambda st: st.literal(noise(1)))):
        st = _Stream()
        st.literal(noise(20))
        for k in range(45):
            st.copy(4 + k % 8, 1 + k % 16)
        last(st)
        rows[f"last-tag-{name}-ends-the-stream"] = st.row()
    return rows


def batches(mix_blocks: int = 1024, file_blocks: int = 256, lineitem_blocks: int = 2048, n: int = BLOCK,
            lineitem_n: int = 1 << 15, device=None) -> dict:
    """{label: (comp, clens, ulens, out_size)}: the corpus mix,
    ``lineitem_blocks`` blocks of ``lineitem_n`` bytes of the benchmark's
    shuffle rows (``profile_encode.lineitem_rows``, drawn on ``device``;
    where the checkout has them) and ``file_blocks`` blocks of each of
    FILES."""
    files = {name: read(name) for name in MIX}
    out = {f"corpus mix, {mix_blocks} blocks": block_batch(repeat_to([files[m] for m in MIX], mix_blocks * n), n)}
    rows = profile_encode.lineitem_rows(lineitem_blocks, lineitem_n, device)
    if rows is not None:
        label = f"lineitem, {lineitem_blocks} blocks of {lineitem_n // 1024} KiB"
        out[label] = block_batch(rows.tobytes(), lineitem_n)
    for name in FILES:
        out[f"{name}, {file_blocks} blocks"] = block_batch(repeat_to([files[name]], file_blocks * n), n)
    return out


def measure(label: str, comp, clens, ulens, out_size: int, dev, libs=None, check_rows: int = 4) -> dict:
    """One batch's record: the kernel's time (``cuda_decode.decode_blocks``;
    its plain version on the CPU) and, with ``libs`` = (instrumented,
    uninstrumented library) on the card, both builds' times, cycles a
    block by phase, tags, literals and copies a block, cycles a tag and the
    occupancy. Every row must decode; the kernel's output must equal the
    plain version's on ``check_rows`` sampled rows, and both builds' the
    kernel's on all."""
    b = len(clens)
    args = tuple(torch.from_numpy(a).to(dev) for a in (comp, clens, ulens)) + (out_size,)
    iters = 5 if dev.type == "cuda" else 1
    rec = {"set": label, "blocks": b, "bytes": int(clens.sum()),
           "ms": time_device_fn(cuda_decode.decode_blocks, args, iters=iters, warmup=1) * 1e3}
    want = cuda_decode.decode_blocks(*args)
    if not bool(want[1].all()):
        raise RuntimeError(f"{label}: a row did not decode")
    pick = np.unique(np.linspace(0, b - 1, min(check_rows, b)).astype(np.int64))
    plain = decode_torch.decode_blocks(*(a[pick].cpu() for a in args[:3]), out_size)
    if not all(torch.equal(x[pick].cpu(), y) for x, y in zip(want, plain)):
        raise RuntimeError(f"{label}: the decoder differs from its plain version")
    if libs is None:
        return rec
    probed, timed = (functools.partial(kernel_profile.launch_decoder, lib.snappy_cuda_decode_blocks) for lib in libs)
    rec["source_ms"] = time_device_fn(timed, args, iters=iters, warmup=1) * 1e3
    rec["profiled_ms"] = time_device_fn(probed, args, iters=iters, warmup=1) * 1e3
    libs[0].prof_reset()
    got = probed(*args)
    torch.cuda.synchronize()
    again = timed(*args)
    if not all(torch.equal(x, y) for x, y in zip((*got, *again), (*want, *want))):
        raise RuntimeError(f"{label}: the source's kernel differs from the decoder")
    counts = (ctypes.c_ulonglong * SLOTS)()
    libs[0].prof_read(counts)
    per = [c / b for c in counts]
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    kernels.check(libs[0].prof_occupancy(comp.shape[1], out_size, ctypes.byref(smem), ctypes.byref(blocks)), "occupancy")
    total = per[TOTAL]
    phases = dict(zip(PHASES, per[:TOTAL]))
    rec["cycles_per_block"] = total
    rec["phases"] = {"walk": total - sum(phases.values()), **phases}
    rec.update({f"{k.replace(' ', '_')}_per_block": per[TOTAL + 1 + i] for i, k in enumerate(COUNTS)})
    tags = rec["tags_per_block"]
    rec["cycles_per_tag"] = total / tags if tags else None
    rec["walk_cycles_per_tag"] = rec["phases"]["walk"] / tags if tags else None
    chased = rec["table_tags_per_block"] + rec["single_tags_per_block"]
    rec["chase_cycles_per_tag"] = rec["phases"]["chase"] / chased if chased else None
    rec["table_share"] = rec["table_tags_per_block"] / tags if tags else None
    rec["tags_per_batch"] = chased / rec["batches_per_block"] if rec["batches_per_block"] else None
    rec["smem_per_block"] = smem.value
    rec["blocks_per_sm"] = blocks.value
    return rec


def line(r: dict) -> str:
    s = f"{r['set']}: {r['bytes']} compressed bytes; kernel {r['ms']:.4f} ms"
    if "phases" not in r:
        return s
    total = r["cycles_per_block"]
    shares = ", ".join(f"{k} {v:.0f} ({v / total:.1%})" for k, v in r["phases"].items())
    counts = ", ".join(f"{r[k.replace(' ', '_') + '_per_block']:.1f} {k}" for k in COUNTS)
    per_tag = "no tags"
    if r["tags_per_block"]:
        per_tag = (f"{r['cycles_per_tag']:.1f} cycles a tag (walk {r['walk_cycles_per_tag']:.1f}); "
                   f"the tables placed {r['table_share']:.1%} of the tags")
    if r["batches_per_block"]:
        per_tag += (f"; {r['tags_per_batch']:.2f} tags a batch, chase {r['chase_cycles_per_tag']:.1f} cycles "
                    "a chased tag")
    return (f"{s}; source {r['source_ms']:.4f} ms, instrumented {r['profiled_ms']:.4f} ms; "
            f"{r['smem_per_block']} bytes of shared memory a block, {r['blocks_per_sm']} blocks an SM; "
            f"cycles a block {total:.0f}: {shares}; a block: {counts}; {per_tag}")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.profile_decode")
    ap.add_argument("--source", type=Path, default=kernels.CSRC / "decode_blocks.cu",
                    help="the decoder source to instrument (default: this package's)")
    ap.add_argument("--window", type=int, help="window bytes to build the source with")
    ap.add_argument("--ring", type=int, help="ring bytes to build the source with")
    try:
        opts = ap.parse_args(argv)
    except SystemExit:
        return 2
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    text = opts.source.read_text()
    defines = [f"-DSNAPPY_K1_WINDOW={opts.window}"] if opts.window else []
    defines += [f"-DSNAPPY_K1_RING={opts.ring}"] if opts.ring else []
    built = kernel_profile.build("decode_blocks", {
        "decode_profiled": kernel_profile.instrument(text, probes(opts.window or window_bytes(text))),
        "decode_timed": text,
    }, defines)
    libs = built["decode_profiled"], built["decode_timed"]
    print(f"source {os.path.relpath(opts.source, REPO)}"
          f"{f', window {opts.window}' if opts.window else ''}{f', ring {opts.ring}' if opts.ring else ''}", flush=True)
    records = []
    for label, (comp, clens, ulens, out_size) in batches(device=dev).items():
        records.append(measure(label, comp, clens, ulens, out_size, dev, libs))
        print(line(records[-1]), flush=True)
    print(json.dumps({"profile_decode": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
