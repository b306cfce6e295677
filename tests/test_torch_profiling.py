"""The port's ``utils/profiling.py`` and the exports of ``utils``.

``profile_to`` around a ``trace_annotation`` region writes one Chrome
trace into the directory it is given (made if missing), which names the
region; ``snappy_tpu_torch.utils`` exports what ``snappy_tpu.utils`` does.
The card's activities in the trace are checked in ``chip_smoke.py``.
"""

import json

import pytest
import torch

import snappy_tpu.utils as ref_utils
import snappy_tpu_torch.utils as utils
from snappy_tpu_torch.utils import profile_to, trace_annotation


def test_exports_match_the_reference():
    assert sorted(utils.__all__) == sorted(ref_utils.__all__)
    for name in ref_utils.__all__:
        assert callable(getattr(utils, name))


def test_profile_to_writes_a_trace_naming_the_region(tmp_path):
    logdir = tmp_path / "a" / "trace"
    with profile_to(str(logdir)):
        with trace_annotation("bench.region_x"):
            torch.arange(1000).sum()
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".json")
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "bench.region_x" for e in events)


def test_profile_to_writes_the_trace_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with profile_to(str(tmp_path)):
            with trace_annotation("failing"):
                raise ValueError("x")
    assert len(list(tmp_path.iterdir())) == 1
