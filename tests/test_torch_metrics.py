"""The port's ``utils/metrics.py`` and ``native/libsnappy.py``.

``libsnappy`` is held against snappy_tpu's binding of the same library:
identical compressed bytes and lengths, round trips, and ValueError on a
corrupt stream. Its cases skip where the system has no libsnappy.
``time_device_fn`` is checked on the CPU, where it times with the host
clock; its CUDA-event path runs in ``chip_smoke.py``.
"""

import json

import pytest
import torch

from snappy_tpu.native import libsnappy as ref_libsnappy
from snappy_tpu_torch.native import libsnappy
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.utils import metrics

from conftest import CORPUS_SMALL, read_testdata


@pytest.fixture
def ls():
    if not libsnappy.available():
        pytest.skip("no libsnappy on this system")
    return libsnappy


def test_available_agrees_with_reference():
    assert libsnappy.available() == ref_libsnappy.available()


@pytest.mark.parametrize("name", CORPUS_SMALL)
def test_libsnappy_compress_matches_reference(ls, name):
    raw = read_testdata(name)
    comp = ls.compress(raw)
    assert comp == ref_libsnappy.compress(raw)
    assert ls.uncompress(comp) == raw
    assert nat.uncompress(comp) == raw
    assert len(comp) <= ls.max_compressed_length(len(raw)) == ref_libsnappy.max_compressed_length(len(raw))


def test_libsnappy_reads_native_streams(ls):
    raw = read_testdata("alice29.txt")
    assert ls.uncompress(nat.compress(raw)) == raw
    assert ls.uncompress(read_testdata("alice29.snappy")) == raw


@pytest.mark.parametrize("name", ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"])
def test_libsnappy_rejects_corrupt(ls, name):
    with pytest.raises(ValueError):
        ls.uncompress(read_testdata(name))


def test_metrics_dump(tmp_path):
    m = metrics.Metrics(run={"device": "cpu"})
    m.add(stage="decode_own", gbps_per_chip=1.5)
    m.add(stage="decode_own_r4control", vs_r4_same_run=0.9)
    path = tmp_path / "m.json"
    m.dump(str(path))
    got = json.loads(path.read_text())
    assert got["run"] == {"device": "cpu"}
    assert got["results"] == [
        {"stage": "decode_own", "gbps_per_chip": 1.5},
        {"stage": "decode_own_r4control", "vs_r4_same_run": 0.9},
    ]
    assert got["ts"] > 0


def test_time_device_fn_on_the_cpu():
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    t = metrics.time_device_fn(fn, (torch.ones(16), 3), iters=5, warmup=2)
    assert len(calls) == 7 and t > 0


@pytest.mark.parametrize("args,iters", [((3,), 1), ((torch.ones(1),), 0)])
def test_time_device_fn_rejects(args, iters):
    with pytest.raises(ValueError):
        metrics.time_device_fn(lambda *a: None, args, iters=iters)
