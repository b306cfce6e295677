"""The readers of the program's own spans and counters
(``perfbench/program.py``) against spans the program's registry recorded:
a batch's mean and self time over the window's last batches, nothing where
the window's records are missing or the cell goes the other way, and
nothing from a program that has no registry."""

import collections
import time

import pytest

from perfbench import program, timeline
from perfbench.registry import Registry
from perfbench.run import Run
from snappy_tpu_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"
REG = Registry()


@pytest.fixture
def fresh(monkeypatch):
    """An empty span buffer and counter registry for the test."""
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.MAX_SPANS))
    monkeypatch.setattr(profiling, "_counts", {})


def run_of(direction: str, batches: int, traced: bool = True) -> Run:
    return Run(f"corpus_64k.{direction}", direction, H100, setup_s=9.0, window_s=1.0, batches=batches, rows=8,
               bytes=8 << 16, comp_bytes=4 << 16, entry_s=[1e-3] * batches,
               trace=timeline.Trace(0.0, 1e6, [], []) if traced else None)


def batch(outer: str, inner: str, sleep_s: float) -> None:
    with profiling.trace_annotation(outer):
        time.sleep(sleep_s)
        with profiling.trace_annotation(inner):
            time.sleep(sleep_s)


def test_decode_readers_take_the_windows_batches(fresh):
    with profiling.recording():
        batch("blocks.decompress", "k1.decode_blocks", 0.004)  # before the window: not read
        for _ in range(3):
            batch("blocks.decompress", "k1.decode_blocks", 0.001)
    api, k1 = profiling.spans("blocks.decompress")[-3:], profiling.spans("k1.decode_blocks")[-3:]
    run = run_of("decode", 3)
    want_k1 = sum(s.end_ns - s.start_ns for s in k1) / 3 / 1e3
    want_self = sum(a.end_ns - a.start_ns - (k.end_ns - k.start_ns) for a, k in zip(api, k1)) / 3 / 1e3
    assert REG.metric("k1.host_us").read(run) == pytest.approx(want_k1)
    assert REG.metric("block_api.self_us.decode").read(run) == pytest.approx(want_self)
    assert 1000 <= want_k1 < 4000 and 1000 <= want_self < 4000
    assert REG.metric("k2.host_us").read(run) is None  # a decode cell runs no K2


def test_encode_reader_takes_the_windows_batches(fresh):
    with profiling.recording():
        for _ in range(2):
            batch("k2.encode_blocks", "k2.launch", 0.001)
    k2 = profiling.spans("k2.encode_blocks")
    run = run_of("encode", 2)
    assert REG.metric("k2.host_us").read(run) == pytest.approx(sum(s.end_ns - s.start_ns for s in k2) / 2 / 1e3)
    for name in ("k1.host_us", "block_api.self_us.decode"):
        assert REG.metric(name).read(run) is None, name  # an encode cell runs no K1


def test_span_readers_give_nothing_where_the_window_recorded_too_few(fresh):
    with profiling.recording():
        for _ in range(2):
            batch("blocks.decompress", "k1.decode_blocks", 0.0)
            batch("k2.encode_blocks", "k2.launch", 0.0)
    for name, direction in (("k1.host_us", "decode"), ("block_api.self_us.decode", "decode"),
                            ("k2.host_us", "encode")):
        assert REG.metric(name).read(run_of(direction, 3)) is None, name  # 3 batches, 2 recorded
        assert REG.metric(name).read(run_of(direction, 2, traced=False)) is None, name
        assert REG.metric(name).read(run_of(direction, 2)) is not None, name


def test_loader_reader_reads_the_counter_at_the_time_of_reading(fresh):
    assert REG.metric("kernels.load_ms").read(run_of("decode", 1)) is None  # nothing loaded
    profiling.count("kernels.load_s", 0.25)
    profiling.count("kernels.load_s", 3.5)
    for direction in ("decode", "encode"):
        assert REG.metric("kernels.load_ms").read(run_of(direction, 1)) == pytest.approx(3750.0)


def test_a_program_without_the_registry_gives_nothing(fresh, monkeypatch):
    with profiling.recording():
        batch("blocks.decompress", "k1.decode_blocks", 0.0)
    profiling.count("kernels.load_s", 1.0)
    monkeypatch.delattr(profiling, "spans")
    assert program.registry() is None
    for name in ("k1.host_us", "block_api.self_us.decode", "k2.host_us", "kernels.load_ms"):
        assert REG.metric(name).read(run_of("decode", 1)) is None, name
