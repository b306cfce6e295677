"""Per-file corpus table: the README's table of compress and uncompress
rates and sizes per corpus file, on the card against the native C++ codec
and libsnappy.

    python -m snappy_tpu_torch.tools.run_corpus [--iters N] [--md PATH] [--device cuda|cpu]

The counterpart of ``benchmarks/run_corpus.py``. For each file of
``FILES``:

- the native codec on the host: the file's compressed size
  (``ratio_native``) and its compress and uncompress rates, medians of
  ``--iters`` calls;
- ``ratio_libsnappy``, libsnappy's headerless bytes on 16 tiled blocks,
  where it is installed;
- on the card (``--device cuda``), the file tiled into one batch of
  ``BATCH`` 64 KiB blocks: the routed encode of ``route.dispatch_routed``
  (the detector, K2 for the compressible blocks, the native encoder for the
  others; ``blocks_host_routed``, ``ratio_device``), its streams gated
  bit-exact through K1, then the routed encode and K1's decode each timed
  with CUDA events (min of 3, ``dev_compress`` and ``dev_uncompress`` in
  bytes a second); and ``ratio_device_array``, the same blocks through
  ``encoder="array"`` (``ops/encode_array.py``), also gated through K1.

On ``--device cpu`` only the host columns are filled, as in the reference
without a TPU. It prints a line a file, then the markdown table; ``--md``
also writes it to a file.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..core import varint
from ..core.config import DEFAULT_MIN_PROFIT
from ..core.constants import BLOCK_SIZE
from ..native import libsnappy as ls
from ..native import runtime as nat
from ..ops import cuda_decode, cuda_encode, route
from ..ops.host import blockify, to_device
from .bench import card_line, decode_args, gate_decode, time_dispatch_stats

REPO = Path(__file__).resolve().parents[2]
FILES = [
    ("txt", "alice29.txt"),
    ("html", "html"),
    ("jpeg", "fireworks.jpeg"),
    ("pdf", "paper-100k.pdf"),
    ("urls", "urls.10K"),
    ("json", "sample-tweet.json"),
]
BATCH = 128  # bench.py's batch


def human(bps: float) -> str:
    return f"{bps / 1e9:.2f} GB/s" if bps >= 1e9 else f"{bps / 1e6:.0f} MB/s"


def median_time(fn, iters: int = 9) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def tile_blocks(raw: bytes, batch: int) -> np.ndarray:
    reps = -(-batch * BLOCK_SIZE // len(raw))
    return np.frombuffer((raw * reps)[: batch * BLOCK_SIZE], np.uint8).reshape(batch, BLOCK_SIZE)


def host_row(label: str, raw: bytes, iters: int) -> dict:
    """The native codec's columns and libsnappy's ratio for one file."""
    comp = nat.compress(raw)
    nat.uncompress(comp)  # warm
    row = {
        "file": label,
        "size": len(raw),
        "ratio_native": len(comp) / len(raw),
        "native_compress": len(raw) / median_time(lambda: nat.compress(raw), iters),
        "native_uncompress": len(raw) / median_time(lambda: nat.uncompress(comp), iters),
    }
    if ls.available():
        hdr = len(varint.encode32(BLOCK_SIZE))
        row["ratio_libsnappy"] = sum(len(ls.compress(b.tobytes())) - hdr for b in tile_blocks(raw, 16)) / (
            16 * BLOCK_SIZE
        )
    return row


def device_row(raw: bytes, device, batch: int = BATCH) -> dict:
    """The card's columns for one file (see the module docstring)."""
    device = torch.device(device)
    blocks = tile_blocks(raw, batch)
    buf, lens = blockify(blocks.reshape(-1), BLOCK_SIZE)
    host_idx = route.host_blocks(buf, lens)
    dev_idx = np.setdiff1d(np.arange(batch), host_idx)
    row = {"blocks_host_routed": len(host_idx)}
    nbytes = batch * BLOCK_SIZE
    decoded = {}
    for encoder, key in (("kernel", "ratio_device"), ("array", "ratio_device_array")):
        streams = route.assemble_routed(
            route.dispatch_routed(buf, lens, host_idx, device, DEFAULT_MIN_PROFIT, encoder)
        )
        row[key] = sum(len(s) for s in streams) / nbytes
        decoded[encoder] = decode_args(streams, device)[0]
        gate_decode(cuda_decode.decode_blocks, decoded[encoder], blocks.tobytes(), f"{encoder} streams")

    dsub, dsublens = to_device(buf[dev_idx], device), to_device(lens[dev_idx], device)

    def routed_call(sub, sublens):
        route.host_blocks(buf, lens)  # the detector
        if len(dev_idx):
            cuda_encode.encode_blocks(sub, sublens, DEFAULT_MIN_PROFIT)  # queued on the card
        route.native_streams_for(buf, lens, host_idx)  # while the card encodes

    t_enc = time_dispatch_stats(routed_call, (dsub, dsublens), iters=3)["min"]
    t_dec = time_dispatch_stats(cuda_decode.decode_blocks, decoded["kernel"], iters=3)["min"]
    row["dev_compress"] = nbytes / t_enc
    row["dev_uncompress"] = nbytes / t_dec
    return row


def table(rows: list[dict]) -> str:
    """The reference's markdown table, with the array encoder's ratio."""
    has_dev = any("dev_compress" in r for r in rows)
    lines = [
        "| file | size | ratio (dev) | ratio (array) | ratio (libsnappy) | dev compress | dev uncompress "
        "| native C++ comp | native C++ unc |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append("| {} | {} | {} | {} | {} | {} | {} | {} | {} |".format(
            r["file"],
            r["size"],
            f"{r['ratio_device']:.3f}" if has_dev else "-",
            f"{r['ratio_device_array']:.3f}" if has_dev else "-",
            f"{r['ratio_libsnappy']:.3f}" if "ratio_libsnappy" in r else "-",
            human(r["dev_compress"]) if has_dev else "-",
            human(r["dev_uncompress"]) if has_dev else "-",
            human(r["native_compress"]),
            human(r["native_uncompress"]),
        ))
    return "\n".join(lines)


def run(device, iters: int = 9, batch: int = BATCH) -> list[dict]:
    """One row a file of ``FILES``; the card's columns where ``device`` is
    a CUDA device. Prints a line a file."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_corpus: --device cuda, but no CUDA device is available")
    rows = []
    for label, name in FILES:
        raw = (REPO / "testdata" / name).read_bytes()
        row = host_row(label, raw, iters)
        if device.type == "cuda":
            row.update(device_row(raw, device, batch))
        rows.append(row)
        print(f"{label}: {row}", flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.run_corpus", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=9)
    p.add_argument("--md", default=None, help="write the markdown table to this path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = run(args.device, args.iters, BATCH)
    md = table(rows)
    print(md, flush=True)
    if args.md:
        on_card = torch.device(args.device).type == "cuda"
        where = card_line() if on_card else "the CPU (host columns only)"
        with open(args.md, "w") as f:
            f.write(
                "# Per-file corpus benchmark\n\n"
                f"Device: {where}; {BATCH} tiled 64 KiB blocks a dispatch; the device decode times the routed "
                "encode's own gated streams (K2 and the native encoder); CUDA events, min of 3. Ratios are "
                "compressed / uncompressed: native of the whole file, the others of tiled blocks (headerless).\n\n"
            )
            f.write(md + "\n")
        print(f"wrote {args.md}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
