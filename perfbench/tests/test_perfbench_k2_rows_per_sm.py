"""``k2.rows_per_sm``: the rows an SM held at once in K2's launches, from
the program's counters ``k2.sm_rows`` over ``k2.rows``; nothing from a
program without them, a process that launched no K2, or a decode run."""

import pytest

from perfbench import program
from perfbench.registry import Registry
from perfbench.run import Run


def _run(direction):
    return Run(f"shuffle_32k.{direction}", direction, "NVIDIA H100 80GB HBM3", setup_s=9.0, window_s=10.0,
               batches=10, rows=20480, bytes=671_088_640, comp_bytes=260_000_000, entry_s=[3e-4])


@pytest.mark.parametrize("counts, want", [
    ({"k2.rows": 4096, "k2.sm_rows": 8192}, 2.0),
    ({"k2.rows": 3072, "k2.sm_rows": 4096}, 4096 / 3072),
    ({"k2.rows": 1024, "k2.sm_rows": 1024}, 1.0),
    ({"k2.launches": 3}, None),
    ({"k2.rows": 0, "k2.sm_rows": 0}, None),
])
def test_rows_per_sm_reads_the_program_counters(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counter", counts.get)
    reader = Registry().metric("k2.rows_per_sm")
    assert reader.read(_run("encode")) == (None if want is None else pytest.approx(want))
    assert reader.read(_run("decode")) is None


def test_rows_per_sm_of_a_program_without_counters(monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: None)
    assert Registry().metric("k2.rows_per_sm").read(_run("encode")) is None
