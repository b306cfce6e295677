"""Where the benchmark finds its pieces, each by the name it goes by.

Under the benchmark's folder, each piece is a file of its own:

- ``configs/<config>.json``: a configuration's sizes, source and cuts;
- ``data/<generator>.py``: a data generator (``generate(config, seed, device)``);
- ``cells/<workload>.json``: a cell's entry, direction and dispatch depth;
- ``entries/<entry>.py``: how a cell's entry is driven and judged;
- ``metrics/<metric>.py``: a metric's reader (``read(run)``) and its
  unit, better side, source, and for a per-layer metric its layer and the
  end-to-end metric it moves.

``BENCHMARK.json`` beside the folder lists which of them are measured. A
piece added as a new file is found by its name with no edit elsewhere.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class Registry:
    """The pieces under ``root`` (the benchmark's folder)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)

    def benchmark(self) -> dict:
        return json.loads((self.root.parent / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} {name!r} ({path} is missing)")
        return json.loads(path.read_text())

    def _module(self, kind: str, name: str) -> types.ModuleType:
        path = self.root / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module {name!r} ({path} is missing)")
        key = f"perfbench_{kind}_{name.replace('.', '_')}_{hashlib.sha1(str(path).encode()).hexdigest()[:8]}"
        if key not in sys.modules:
            spec = importlib.util.spec_from_file_location(key, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[key] = module  # dataclasses look their module up there
            try:
                spec.loader.exec_module(module)
            except BaseException:
                del sys.modules[key]
                raise
        return sys.modules[key]

    def _names(self, kind: str, suffix: str) -> list[str]:
        return sorted(p.name[: -len(suffix)] for p in (self.root / kind).glob(f"*{suffix}")
                      if not p.name.startswith("_"))

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def cell(self, name: str) -> dict:
        return self._json("cells", name)

    def generator(self, name: str) -> types.ModuleType:
        return self._module("data", name)

    def entry(self, name: str) -> types.ModuleType:
        return self._module("entries", name)

    def metric(self, name: str) -> types.ModuleType:
        return self._module("metrics", name)

    def configs(self) -> list[str]:
        return self._names("configs", ".json")

    def cells(self) -> list[str]:
        return self._names("cells", ".json")

    def metrics(self) -> list[str]:
        return self._names("metrics", ".py")

    def workload(self, name: str) -> dict:
        """The ``workloads`` entry of ``BENCHMARK.json`` named ``name``."""
        for w in self.benchmark()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def metric_names(self, workload: str, trace: bool) -> list[str]:
        """The metrics a run of ``workload`` reports: with ``trace`` its
        per-layer metrics, without its end-to-end ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m["name"] for m in self.benchmark()[kind] if workload in m.get("workloads", [workload])]
