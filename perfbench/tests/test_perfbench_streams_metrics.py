"""The Parquet cell's per-layer readers: ``k4.roofline`` from hand-counted
bytes and a trace's K4 time, ``streams.host_us`` from the program's span
``streams.decompress``, ``streams.segments_per_stream`` from its counters;
nothing from a program without them (the parent of this cell), a run not
traced, or an encode cell."""

import collections
import time

import pytest

from perfbench import program, roofline_k4, timeline
from perfbench.registry import Registry
from perfbench.run import Run
from snappy_tpu_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"
REG = Registry()
K4 = "void (anonymous namespace)::segment_streams_kernel(unsigned char const*, long)"


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.MAX_SPANS))
    monkeypatch.setattr(profiling, "_counts", {})


def run_of(direction: str = "decode", batches: int = 4, device=()) -> Run:
    return Run("parquet_lineitem.decode", direction, H100, setup_s=30.0, window_s=1.0, batches=batches, rows=1000,
               bytes=90_000_000, comp_bytes=50_000_000, entry_s=[1e-3] * batches,
               trace=timeline.Trace(0.0, 1e6, list(device), []))


def test_k4_bytes_are_counted_by_hand():
    # 2 streams of 100 bytes in all, cut into 3 segments: the streams and
    # 24 bytes of arguments a stream read; 28 bytes a segment and a flag a
    # stream written.
    assert roofline_k4.segment_bytes(100, 2, 3) == 100 + 48 + 84 + 2
    assert roofline_k4.share(3_350_000, 0.001, H100) == pytest.approx(0.1)


def test_k4_roofline_reads_the_trace_and_the_counters(fresh):
    profiling.count("streams.streams", 100)
    profiling.count("streams.segments", 250)
    run = run_of(device=[(K4, 0.0, 2e5), ("decode_blocks_kernel", 2e5, 9e5)])
    want = 100 * roofline_k4.segment_bytes(50_000_000, 1000, 2500) / 3.35e12 / 0.2
    assert REG.metric("k4.roofline").read(run) == pytest.approx(want)
    assert REG.metric("streams.segments_per_stream").read(run) == pytest.approx(2.5)
    assert REG.metric("k4.roofline").read(run_of(device=[("decode_blocks_kernel", 0.0, 9e5)])) is None
    assert REG.metric("k4.roofline").read(run_of("encode", device=[(K4, 0.0, 2e5)])) is None


def test_streams_host_us_takes_the_windows_batches(fresh):
    with profiling.recording():
        for pause in (0.004, 0.001, 0.001):
            with profiling.trace_annotation("streams.decompress"):
                time.sleep(pause)
    spans = profiling.spans("streams.decompress")
    run = run_of(batches=2)
    assert REG.metric("streams.host_us").read(run) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in spans[-2:]) / 2 / 1e3)
    assert REG.metric("streams.host_us").read(run_of(batches=4)) is None  # 4 batches, 3 recorded
    untraced = run_of(batches=2)
    untraced.trace = None
    assert REG.metric("streams.host_us").read(untraced) is None


def test_a_program_without_k4_gives_nothing(fresh, monkeypatch):
    run = run_of(device=[(K4, 0.0, 2e5)])
    for name in ("k4.roofline", "streams.segments_per_stream", "streams.host_us"):
        assert REG.metric(name).read(run) is None, name  # no counters, no spans
    profiling.count("streams.streams", 10)
    profiling.count("streams.segments", 20)
    monkeypatch.setattr(program, "registry", lambda: None)
    for name in ("k4.roofline", "streams.segments_per_stream", "streams.host_us"):
        assert REG.metric(name).read(run) is None, name
