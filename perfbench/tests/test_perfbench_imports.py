"""Nothing a run loads is JAX or the JAX package, top-level names compared
whole: the port's name begins with the JAX package's."""

import subprocess
import sys

from perfbench.registry import ROOT
from perfbench.run import forbidden_modules


def test_top_level_names_are_compared_whole():
    found = forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "snappy_tpu",
                               "snappy_tpu.ops.select", "snappy_tpu_torch", "snappy_tpu_torch.ops.select",
                               "jaxtyping", "flaxen", "snappy_tpuish", "numpy"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "snappy_tpu", "snappy_tpu.ops.select"]


RUN_ON_THE_CPU = """
import sys, torch
from pathlib import Path
from perfbench import control, run
from perfbench.tests.helpers import tiny_copy
reg = tiny_copy(Path(sys.argv[1]))
for w in [x["name"] for x in reg.benchmark()["workloads"]]:
    r = run.run_cell(w, 2**31 + 5, 0.2, trace=True, registry=reg, device=torch.device("cpu"))
    assert r["correct"], r
    control.readings(w, 3, True, None, registry=reg, device=torch.device("cpu"))
print(run.forbidden_modules(sys.modules))
"""


def test_a_run_loads_no_forbidden_module(tmp_path):
    proc = subprocess.run([sys.executable, "-c", RUN_ON_THE_CPU, str(tmp_path)], cwd=ROOT.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
