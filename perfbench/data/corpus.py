"""Blocks of google/snappy's benchmark corpus, the files in turn.

The configuration names the files, read from the checkout's ``testdata/``
(google/snappy's own copies, which the repository keeps unedited), and the
sizes. The seed rotates the files' order and picks where in their
concatenation the blocks start; every seed gives every file the same share
of the bytes. The blocks are made on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.registry import ROOT

CORPUS = ROOT.parent / "testdata"


def concatenation(files: list[str], seed: int) -> np.ndarray:
    """The files' bytes in the order the seed rotates them to."""
    bufs = [(CORPUS / name).read_bytes() for name in files]
    turn = seed % len(bufs)
    return np.frombuffer(b"".join(bufs[turn:] + bufs[:turn]), np.uint8)


def generate(config: dict, seed: int, device: torch.device) -> torch.Tensor:
    """u8[blocks, block_size]: the corpus in turn from a seeded start, on
    the host."""
    size = config["block_size"]
    total = config["blocks_per_batch"] * config["resident_batches"] * size
    stream = concatenation(config["files"], seed)
    start = int(np.random.default_rng(seed).integers(len(stream)))
    tiled = np.tile(stream, (start + total) // len(stream) + 1)[start : start + total]
    return torch.from_numpy(tiled.reshape(-1, size))
