"""On the card: each cell runs short and is correct, and its control is
not. Run there with ``python3 -m pytest perfbench/tests -m card``."""

import pytest

from perfbench import control
from perfbench.registry import Registry
from perfbench.run import run_cell

WORKLOADS = [w["name"] for w in Registry().benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_with_its_metrics(cuda_device, workload):
    reg = Registry()
    result = run_cell(workload, 2**31 + 101, 1.0, trace=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == set(reg.metric_names(workload, True))
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(cuda_device, workload):
    r = control.readings(workload, 2**31 + 102, True, None)
    assert r["program_rows_wrong"] == 0 and r["control_rows_wrong"] > 0
