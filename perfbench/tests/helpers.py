"""A copy of the benchmark with every configuration cut to a few small
blocks, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.registry import ROOT, Registry

TINY = {"corpus_64k": 4096, "shuffle_32k": 4096}


def tiny_copy(tmp: Path, rows: int = 8, batches: int = 2) -> Registry:
    shutil.copytree(ROOT, tmp / "perfbench", ignore=shutil.ignore_patterns("_build", "__pycache__", "tests"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for path in (tmp / "perfbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config.update(block_size=TINY.get(config["name"], 4096), blocks_per_batch=rows, resident_batches=batches)
        path.write_text(json.dumps(config))
    return Registry(tmp / "perfbench")
