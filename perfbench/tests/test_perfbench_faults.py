"""A run judges what its timed path produced: with the program broken
underneath, ``correct`` comes out false; the controls read above the limit.

Runs go on the CPU (the look for a card skipped) at a few small blocks, the
program's plain versions in the kernels' places.
"""

import pytest
import torch

from perfbench import control, faults
from perfbench.run import run_cell
from perfbench.tests.helpers import tiny_copy

CPU = torch.device("cpu")
CELLS = ["corpus_64k.decode", "shuffle_32k.encode", "corpus_64k.encode", "shuffle_32k.decode"]


@pytest.fixture
def reg(tmp_path):
    return tiny_copy(tmp_path)


def break_program(monkeypatch, workload: str, fault: str) -> None:
    if workload.endswith(".decode"):
        from snappy_tpu_torch.parallel import distributed

        whole = distributed.decompress_blocks
        broken = faults.plant(fault, lambda *a, **k: tuple(part[0] for part in whole(*a, **k)))
        monkeypatch.setattr(distributed, "decompress_blocks", lambda *a, **k: tuple([t] for t in broken(*a, **k)))
    else:
        from snappy_tpu_torch.ops import cuda_encode

        monkeypatch.setattr(cuda_encode, "encode_blocks", faults.plant(fault, cuda_encode.encode_blocks))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(reg, workload):
    result = run_cell(workload, 2**33 + 1, 0.2, trace=False, registry=reg, device=CPU)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result)[-1] == "checks" and result["checks"]["rows_wrong"] == {"value": 0, "limit": 0, "rule": "<="}
    assert set(result["metrics"]) == set(reg.metric_names(workload, False))


def test_a_run_names_what_it_built(reg, monkeypatch):
    from perfbench import encoder

    monkeypatch.setattr(encoder, "BUILD_DIR", reg.root / "_build")
    monkeypatch.setattr(encoder, "_libs", {})
    first = run_cell("corpus_64k.decode", 2**33 + 4, 0.1, trace=False, registry=reg, device=CPU)
    again = run_cell("corpus_64k.decode", 2**33 + 5, 0.1, trace=False, registry=reg, device=CPU)
    assert any(name.startswith("perfbench/_build/snappy_encoder-") for name in first["built"]), first["built"]
    assert again["built"] == [] and again["correct"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", ["corpus_64k.decode", "shuffle_32k.encode"])
def test_a_broken_program_is_not_correct(reg, monkeypatch, workload, fault):
    break_program(monkeypatch, workload, fault)
    result = run_cell(workload, 2**33 + 2, 0.2, trace=False, registry=reg, device=CPU)
    assert not result["correct"] and result["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_above_the_limit(reg, workload):
    r = control.readings(workload, 2**33 + 3, True, None, registry=reg, device=CPU)
    assert r["program_rows_wrong"] == 0 and r["control_rows_wrong"] > 0
