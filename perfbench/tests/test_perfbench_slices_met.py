"""The Parquet cell's reader of K4's slices: ``streams.slices_met`` from the
program's counters ``streams.slices_met`` over ``streams.slices``; nothing
from a program without them (the parent of this metric), a run that charted
no slice, or an encode cell."""

import collections

import pytest

from perfbench import program, timeline
from perfbench.registry import Registry
from perfbench.run import Run
from snappy_tpu_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"
REG = Registry()


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.MAX_SPANS))
    monkeypatch.setattr(profiling, "_counts", {})


def run_of(direction: str = "decode", batches: int = 4) -> Run:
    return Run("parquet_lineitem.decode", direction, H100, setup_s=30.0, window_s=1.0, batches=batches, rows=1000,
               bytes=90_000_000, comp_bytes=50_000_000, entry_s=[1e-3] * batches,
               trace=timeline.Trace(0.0, 1e6, [], []))


def test_slices_met_is_the_share_of_k4s_slices_the_join_met(fresh):
    profiling.count("streams.slices", 400)
    profiling.count("streams.slices_met", 390)
    profiling.count("streams.slices_walked", 60)
    assert REG.metric("streams.slices_met").read(run_of()) == pytest.approx(97.5)
    assert REG.metric("streams.slices_met").read(run_of("encode")) is None
    module = REG.metric("streams.slices_met")
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES) == ("kernel K4", "%", "program_counter",
                                                                        "decode_gbps")


def test_slices_met_gives_nothing_without_the_counters_or_a_slice(fresh, monkeypatch):
    # A K4 without slices counts none.
    profiling.count("streams.streams", 10)
    profiling.count("streams.segments", 20)
    assert REG.metric("streams.slices_met").read(run_of()) is None
    profiling.count("streams.slices", 0)
    profiling.count("streams.slices_met", 0)
    assert REG.metric("streams.slices_met").read(run_of()) is None  # short streams alone: nothing charted
    profiling.count("streams.slices", 5)
    monkeypatch.setattr(program, "registry", lambda: None)
    assert REG.metric("streams.slices_met").read(run_of()) is None
