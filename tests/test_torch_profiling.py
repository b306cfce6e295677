"""The port's ``utils/profiling.py`` and the exports of ``utils``.

``profile_to`` around a ``trace_annotation`` region writes one Chrome
trace into the directory it is given (made if missing), which names the
region; ``snappy_tpu_torch.utils`` exports what ``snappy_tpu.utils`` does.
Spans record only while tracing is on, nest on their thread, give self
times, stay within their bound and share the trace's clock; counters are
copies whose differences readers take; the block API, the wrappers and the
kernel loader open their spans and count what they do. The card's
activities in the trace are checked in ``chip_smoke.py``.
"""

import collections
import json
import statistics
import threading
import time
import types
from collections import defaultdict

import numpy as np
import pytest
import torch

import snappy_tpu.utils as ref_utils
import snappy_tpu_torch.utils as utils
from snappy_tpu_torch import compress_framed, uncompress_framed
from snappy_tpu_torch.ops import cuda_encode, kernels
from snappy_tpu_torch.ops.encode_torch import ENC_PAD
from snappy_tpu_torch.parallel import distributed
from snappy_tpu_torch.utils import profile_to, profiling, trace_annotation


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


def test_a_span_with_tracing_off_records_nothing(monkeypatch):
    """Neither a profiler nor ``recording()`` open: a span is the shared
    null context, calls no ``record_function`` and records nothing."""

    def no_record_function(*_):
        raise AssertionError("record_function was called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    kept = len(profiling.spans())
    first, again = profiling.trace_annotation("test.off"), profiling.trace_annotation("test.off")
    assert first is again
    with first as span:
        assert span is None
    assert len(profiling.spans()) == kept


def test_spans_nest_on_their_thread_and_give_self_time(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", lambda *_: pytest.fail("no profiler is on"))
    others = []

    def elsewhere():
        with profiling.trace_annotation("test.thread") as s:
            others.append(s)

    with profiling.recording():
        with profiling.trace_annotation("test.outer") as outer:
            with profiling.trace_annotation("test.inner") as inner:
                with profiling.trace_annotation("test.innermost") as innermost:
                    time.sleep(0.002)
            with profiling.trace_annotation("test.second"):
                time.sleep(0.001)
            t = threading.Thread(target=elsewhere)
            t.start()
            t.join(timeout=30)
            time.sleep(0.001)
    assert not t.is_alive()
    (thread,) = others
    second = profiling.spans("test.second")[-1]
    assert outer.parent is None and outer.request == outer.id
    assert inner.parent == outer.id and second.parent == outer.id and innermost.parent == inner.id
    assert inner.request == second.request == innermost.request == outer.id
    assert outer.thread == inner.thread == threading.get_ident() != thread.thread
    assert thread.parent is None and thread.request == thread.id  # another thread: a request of its own
    dur = {s.name: s.end_ns - s.start_ns for s in (outer, inner, innermost, second)}
    assert profiling.self_ns(outer) == dur["test.outer"] - dur["test.inner"] - dur["test.second"]
    assert profiling.self_ns(inner) == dur["test.inner"] - dur["test.innermost"]
    assert profiling.self_ns(innermost) == dur["test.innermost"] >= 2_000_000
    assert profiling.self_ns(outer) >= 1_000_000
    assert [s.name for s in profiling.spans()[-5:]] == [
        "test.innermost", "test.inner", "test.second", "test.thread", "test.outer"]


def test_the_bound_on_spans_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=3))
    before = profiling.counters()
    with profiling.recording():
        for i in range(5):
            with profiling.trace_annotation(f"test.bound_{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["test.bound_2", "test.bound_3", "test.bound_4"]
    assert profiling.since(before)["trace.spans_dropped"] == 2
    assert profiling.spans("test.bound_4")[0].name == "test.bound_4"


def test_counters_are_copies_whose_differences_readers_take():
    before = profiling.counters()
    profiling.count("test.items", 3)
    profiling.count("test.items")
    profiling.count("test.seconds", 0.25)
    copy = profiling.counters()
    copy["test.items"] = -1  # a copy: the registry is not touched
    moved = profiling.since(before)
    assert moved["test.items"] == 4 and moved["test.seconds"] == 0.25 and moved["test.never"] == 0


def test_profile_to_holds_every_span_on_the_spans_clock(tmp_path):
    """Every program span recorded under the profiler is in the exported
    trace under its name, and the trace's clock (``ts`` microseconds after
    ``baseTimeNanoseconds``) is the spans' ``time.time_ns()``."""
    raw = bytes(range(256)) * 700
    start_ns = time.time_ns()
    with profile_to(str(tmp_path)):
        for _ in range(3):
            frame = compress_framed(raw, device="cpu")
            assert uncompress_framed(frame, device="cpu") == raw
    recorded = [s for s in profiling.spans() if s.start_ns >= start_ns]
    trace = json.loads(next(tmp_path.iterdir()).read_text())
    base = trace["baseTimeNanoseconds"]
    events = defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            events[e["name"]].append(float(e["ts"]) * 1000 + base)
    names = {s.name for s in recorded}
    assert {"framed.dispatch_compress", "framed.crc", "host.stage", "k2.encode_blocks", "framed.parse",
            "host.pack", "k1.decode_blocks", "framed.join", "framed.assemble_uncompress"} <= names
    diffs = []
    for name in names:
        mine = sorted(s.start_ns for s in recorded if s.name == name)
        assert len(events[name]) == len(mine), name
        diffs += [abs(a - b) for a, b in zip(mine, sorted(events[name]))]
    assert statistics.median(diffs) <= 50_000


def test_cpu_calls_open_the_block_api_and_wrapper_spans():
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    comp[0, :5] = torch.tensor([3 << 2, *b"abcd"], dtype=torch.uint8)  # one literal, "abcd"
    clens, ulens = torch.tensor([5, 0], dtype=torch.int32), torch.tensor([4, 0], dtype=torch.int32)
    blocks = torch.zeros((2, 64 + ENC_PAD), dtype=torch.uint8)
    blocks[0, :64] = torch.from_numpy(np.frombuffer(b"abcd" * 16, np.uint8).copy())
    blens = torch.tensor([64, 0], dtype=torch.int32)
    before = profiling.counters()
    with profiling.recording():
        outs, oks, _ = distributed.decompress_blocks(comp, clens, ulens, distributed.mesh_1d(["cpu"]), 16)
        cuda_encode.encode_blocks(blocks, blens, 2)
    assert bytes(outs[0][0, :4].tolist()) == b"abcd" and oks[0].tolist() == [True, True]
    api, k1, k2 = (profiling.spans(n)[-1] for n in ("blocks.decompress", "k1.decode_blocks", "k2.encode_blocks"))
    assert k1.parent == api.id and api.start_ns <= k1.start_ns <= k1.end_ns <= api.end_ns
    assert k2.parent is None and k2.request == k2.id
    assert profiling.self_ns(api) == api.end_ns - api.start_ns - (k1.end_ns - k1.start_ns)
    moved = profiling.since(before)
    assert moved["k1.launches"] == moved["k2.launches"] == 0
    assert not [s for s in profiling.spans("k1.launch") if s.start_ns >= api.start_ns]  # no launch on the CPU


def test_the_loaders_slow_path_is_counted_once(monkeypatch):
    built = []

    class Library:
        def __init__(self, path):
            self.entries = {}

        def __getattr__(self, name):
            return self.__dict__["entries"].setdefault(name, types.SimpleNamespace())

    def build_shared(compiler, sources, stem):
        built.append(stem)
        time.sleep(0.02)
        return f"/nonexistent/{stem}.so"

    monkeypatch.setattr(kernels, "_libraries", {})
    monkeypatch.setattr(kernels, "_namespaces", {})
    monkeypatch.setattr(kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kernels, "build_shared", build_shared)
    monkeypatch.setattr(kernels.ctypes, "CDLL", Library)
    before = profiling.counters()
    with profiling.recording():
        kernels.load("decode_blocks")
    first = profiling.since(before)["kernels.load_s"]
    load, build = profiling.spans("kernels.load")[-1], profiling.spans("kernels.build")[-1]
    assert built == ["snappy_cuda_decode_blocks"] and first >= 0.02
    assert build.parent == load.id and (build.end_ns - build.start_ns) >= 20_000_000
    again = profiling.counters()
    kernels.load("decode_blocks")
    assert profiling.since(again)["kernels.load_s"] == 0 and built == ["snappy_cuda_decode_blocks"]
