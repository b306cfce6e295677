"""The Parquet write cell's pieces on the CPU: its configuration against the
read cell's, the entry's judge, faults planted in its results, its control,
a whole run of the cell at a small size, and its per-layer readers
(``k5.roofline`` from hand-counted bytes, ``streams.host_us.encode`` from
the program's span ``streams.compress``; nothing from a program without
them, as the parent of this cell has none)."""

import collections
import json
import shutil
import time

import pytest
import torch

from perfbench import faults, program, roofline_k5, timeline
from perfbench.data import parquet_lineitem as pq
from perfbench.registry import ROOT, Registry
from perfbench.run import Run, run_cell
from snappy_tpu_torch.utils import profiling

REG = Registry()
CPU = torch.device("cpu")
SEED = 2**31 + 2626
H100 = "NVIDIA H100 80GB HBM3"
K5 = "void (anonymous namespace)::join_streams_kernel(unsigned char const*, long)"
SMALL = {"block_size": 4096, "page_row_count_limit": 2000, "resident_row_groups": 2}


def test_the_write_config_holds_the_read_configs_sizes():
    read, write = REG.config("parquet_lineitem"), REG.config("parquet_lineitem_write")
    words = {"name", "source", "deployment", "guarantees", "assumed"}
    assert {k: v for k, v in read.items() if k not in words} == {k: v for k, v in write.items() if k not in words}
    bench = REG.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    assert configs["parquet_lineitem_write"]["reduced"] == configs["parquet_lineitem"]["reduced"] == write["reduced"]
    # The writer is its own deployment: it names the writer's page store, not the reader's defaults alone.
    assert configs["parquet_lineitem_write"]["source"] == write["source"] != read["source"]
    assert write["source"].split()[0].split(";")[0] != read["source"].split()[0]
    assert REG.cell("parquet_lineitem_write.encode") == {"entry": "compress_streams", "direction": "encode",
                                                         "depth": 2}


@pytest.fixture(scope="module")
def state():
    from perfbench.entries import compress_streams as entry

    config = dict(REG.config("parquet_lineitem_write"), **SMALL)
    return entry, entry.prepare(pq.generate(config, SEED, CPU), config, {}, CPU)


def test_the_judge_counts_pages_wrong(state):
    entry, st = state
    result = entry.call(st, 0)
    n = len(st.groups[0].host["starts"])
    assert entry.wrong_rows(st, 0, result) == 0
    work = entry.work(st, 0, result)
    assert work["rows"] == n and work["bytes"] == int(st.groups[0].host["ulens"].sum())
    assert int(work["comp_bytes"].sum()) == int(result[2].sum())
    comp, cstarts, clens = (t.clone() for t in result)
    long_page = int(torch.argmax(clens))
    comp[cstarts[long_page] + clens[long_page] - 1] ^= 1  # a body byte
    comp[cstarts[1]] ^= 2  # a header
    clens[2] = -1  # refused
    assert entry.wrong_rows(st, 0, (comp, cstarts, clens)) == 3
    assert entry.wrong_rows(st, 0, (result[0], result[1][:-1], result[2])) == n
    assert entry.wrong_rows(st, 1, result) > 0  # another row group's pages


def test_a_stream_over_its_bound_is_wrong(state):
    """A stream whose length passes max_compressed_length(u) plus its
    header counts wrong even where its bytes decode: a page of literals
    stated longer by the bytes after it."""
    entry, st = state
    comp, cstarts, clens = (t.clone() for t in entry.call(st, 0))
    page = int(torch.argmin(clens))
    u = int(st.groups[0].host["ulens"][page])
    clens[page] = 32 + u + u // 6 + 6
    assert entry.wrong_rows(st, 0, (comp, cstarts, clens)) >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_planted_fault_reads_false(state, fault):
    entry, st = state
    broken = faults.plant(fault, entry.call)
    wrong = sum(entry.wrong_rows(st, b, broken(st, b)) for b in range(entry.batches(st)))
    assert wrong > 0


def test_the_control_reads_wrong(state):
    entry, st = state
    wrong = [entry.wrong_rows(st, b, entry.control(st, b)) for b in range(entry.batches(st))]
    assert sum(wrong) > 0


def _small_registry(tmp_path) -> Registry:
    shutil.copytree(ROOT, tmp_path / "perfbench", ignore=shutil.ignore_patterns("_build", "__pycache__", "tests"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "perfbench" / "configs" / "parquet_lineitem_write.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **SMALL)))
    return Registry(tmp_path / "perfbench")


def test_a_run_of_the_cell_is_correct_and_a_broken_program_is_not(tmp_path, monkeypatch):
    from snappy_tpu_torch.parallel import distributed

    reg = _small_registry(tmp_path)
    result = run_cell("parquet_lineitem_write.encode", SEED, 0.05, trace=False, registry=reg, device=CPU)
    assert result["correct"] and {"encode_gbps", "compressed_ratio", "setup_s"} <= set(result["metrics"])
    assert 0 < result["metrics"]["compressed_ratio"]["value"] < 1
    whole = distributed.compress_streams

    def altered(*args, **kwargs):
        comp, cstarts, clens = whole(*args, **kwargs)
        comp = comp.clone()
        comp[cstarts + clens.long() - 1] ^= 0x55  # the last byte of every stream
        return comp, cstarts, clens

    monkeypatch.setattr(distributed, "compress_streams", altered)
    result = run_cell("parquet_lineitem_write.encode", SEED, 0.05, trace=False, registry=reg, device=CPU)
    assert not result["correct"] and result["checks"]["rows_wrong"]["value"] > 0


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=profiling.MAX_SPANS))
    monkeypatch.setattr(profiling, "_counts", {})


def run_of(direction: str = "encode", batches: int = 4, device=()) -> Run:
    return Run("parquet_lineitem_write.encode", direction, H100, setup_s=30.0, window_s=1.0, batches=batches,
               rows=1000, bytes=90_000_000, comp_bytes=40_000_000, entry_s=[1e-3] * batches,
               trace=timeline.Trace(0.0, 1e6, list(device), []))


def test_k5_bytes_are_counted_by_hand():
    # 2 streams of 100 bytes in all, headers included, joined from 3
    # fragments: the streams less 5 bytes a header and 4 bytes a fragment
    # read; the streams and 12 bytes a stream written.
    assert roofline_k5.join_bytes(100, 2, 3) == 90 + 12 + 100 + 24
    assert roofline_k5.join_bytes(4, 2, 0) == 4 + 24


def test_k5_roofline_reads_the_trace_and_the_counters(fresh):
    profiling.count("streams.enc_streams", 100)
    profiling.count("streams.enc_fragments", 205)
    run = run_of(device=[(K5, 0.0, 1e3), ("encode_blocks_kernel", 1e3, 9e5)])
    want = 100 * roofline_k5.join_bytes(40_000_000, 1000, 2050) / 3.35e12 / 1e-3
    assert REG.metric("k5.roofline").read(run) == pytest.approx(want)
    assert REG.metric("k5.roofline").read(run_of(device=[("encode_blocks_kernel", 0.0, 9e5)])) is None
    assert REG.metric("k5.roofline").read(run_of("decode", device=[(K5, 0.0, 1e3)])) is None


def test_streams_host_us_encode_takes_the_windows_batches(fresh):
    with profiling.recording():
        for pause in (0.004, 0.001, 0.001):
            with profiling.trace_annotation("streams.compress"):
                time.sleep(pause)
    spans = profiling.spans("streams.compress")
    assert REG.metric("streams.host_us.encode").read(run_of(batches=2)) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in spans[-2:]) / 2 / 1e3)
    assert REG.metric("streams.host_us.encode").read(run_of(batches=4)) is None  # 4 batches, 3 recorded
    assert REG.metric("streams.host_us.encode").read(run_of("decode", batches=2)) is None


def test_a_program_without_k5_gives_nothing(fresh, monkeypatch):
    run = run_of(device=[(K5, 0.0, 1e3)])
    for name in ("k5.roofline", "streams.host_us.encode"):
        assert REG.metric(name).read(run) is None, name  # no counters, no spans
    profiling.count("streams.enc_streams", 10)
    profiling.count("streams.enc_fragments", 20)
    monkeypatch.setattr(program, "registry", lambda: None)
    for name in ("k5.roofline", "streams.host_us.encode"):
        assert REG.metric(name).read(run) is None, name


def test_the_cell_reports_its_metrics():
    names = set(REG.metric_names("parquet_lineitem_write.encode", True))
    assert {"k2.roofline", "k5.roofline", "streams.host_us.encode", "idle_share.encode", "k2.rows_per_sm",
            "kernels.load_ms"} <= names
    assert set(REG.metric_names("parquet_lineitem_write.encode", False)) == {"encode_gbps", "compressed_ratio",
                                                                             "setup_s"}
