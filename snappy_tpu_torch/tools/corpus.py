"""The corpus data the tools and ``chip_smoke.py`` code: the corpus mix, its
files, and batches of their 64 KiB blocks as the native encoder writes them.

``perfbench/`` keeps its own copies, so that the benchmark reads nothing of
the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..native import runtime as nat
from ..ops.host import pack_rows

BLOCK = 1 << 16
REPO = Path(__file__).resolve().parents[2]
# The corpus mix, in bench.py's order.
MIX = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]
# The single files the kernel profilers run beside the mix.
FILES = ["alice29.txt", "html", "kppkn.gtb", "fireworks.jpeg"]


def read(name: str) -> bytes:
    """The bytes of ``testdata/<name>``."""
    return (REPO / "testdata" / name).read_bytes()


def repeat_to(data: list[bytes], n: int) -> bytes:
    """``n`` bytes of the buffers of ``data`` in turn."""
    out, total, i = [], 0, 0
    while total < n:
        out.append(data[i % len(data)])
        total += len(out[-1])
        i += 1
    return b"".join(out)[:n]


def corpus_stream(target: int) -> bytes:
    """``target`` bytes of the corpus files in turn."""
    return repeat_to([read(n) for n in MIX], target)


def block_batch(raw: bytes, n: int = BLOCK):
    """The native encoder's streams of the ``n``-byte blocks of ``raw`` as
    the block decoders' arguments, on the host: (comp, clens, ulens,
    out_size)."""
    rows = len(raw) // n
    buf = np.frombuffer(raw[: rows * n], np.uint8).reshape(rows, n).copy()
    streams = nat.compress_rows(buf, np.full(rows, n, np.int32), np.arange(rows))
    clens = np.array([len(s) for s in streams], np.int64)
    comp = pack_rows(np.frombuffer(b"".join(streams), np.uint8), np.concatenate([[0], np.cumsum(clens)[:-1]]), clens)
    return comp, clens.astype(np.int32), np.full(rows, n, np.int32), n
