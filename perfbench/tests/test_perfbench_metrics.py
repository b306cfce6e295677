"""The yardstick's arithmetic: rooflines from hand-counted bytes, and the
card's busy time and idle gaps from a trace."""

import json

import pytest

from perfbench import roofline, timeline
from perfbench.registry import Registry
from perfbench.run import Run

H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_bytes_are_counted_by_hand():
    # 2 rows: 100 stream bytes and 8 bytes of lengths a row read; 300
    # bytes, a flag and a length (5 bytes) a row written.
    assert roofline.decode_bytes(100, 2, 300) == 100 + 16 + 300 + 10
    # 2 rows: 300 bytes and a length a row read; 100 stream bytes and a
    # length a row written.
    assert roofline.encode_bytes(300, 2, 100) == 300 + 8 + 100 + 8
    assert roofline.share(3_350_000, 0.001, H100) == pytest.approx(0.1)
    assert roofline.share(3_350_000, 0.001, "another card") is None
    assert roofline.share(1, 0.0, H100) is None


def trace_file(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [dict(ph="X", **e) for e in events]}))
    return path


def test_busy_time_idle_gaps_and_kernel_time(tmp_path):
    events = [
        {"name": "perfbench.window", "cat": "user_annotation", "ts": 100, "dur": 110},
        {"name": "perfbench.entry", "cat": "user_annotation", "ts": 100, "dur": 15},
        {"name": "perfbench.wait", "cat": "user_annotation", "ts": 150, "dur": 45},
        {"name": "k(int)", "cat": "kernel", "ts": 90, "dur": 30},  # 10 before the window
        {"name": "k(int)", "cat": "kernel", "ts": 110, "dur": 20},  # overlaps the first
        {"name": "Memcpy", "cat": "gpu_memcpy", "ts": 160, "dur": 10},
        {"name": "aten::empty", "cat": "cpu_op", "ts": 100, "dur": 5},
    ]
    tl = timeline.read(trace_file(tmp_path, events))
    assert tl.window_s == pytest.approx(110e-6)
    assert tl.busy_s == pytest.approx(40e-6)  # [100, 130) and [160, 170)
    assert tl.gaps() == [(130, 160), (170, 210)]
    assert tl.kernel_seconds(r"^k\(") == pytest.approx(40e-6)
    assert tl.device_ops() == [["k(int)", pytest.approx(40e-6)], ["Memcpy", pytest.approx(10e-6)]]
    # The first gap begins between spans, the second inside the wait.
    assert tl.idle_gaps() == [["perfbench.wait", pytest.approx(40e-6)], ["perfbench.window", pytest.approx(30e-6)]]
    assert timeline.read(trace_file(tmp_path, events[3:])) is None


def test_readers_report_nothing_where_they_find_nothing(tmp_path):
    reg = Registry()
    run = Run("corpus_64k.decode", "decode", H100, setup_s=9.0, window_s=2.0, batches=10, rows=100,
              bytes=4_000_000_000, comp_bytes=2_000_000_000, entry_s=[1e-4, 3e-4])
    assert reg.metric("decode_gbps").read(run) == pytest.approx(2.0)
    assert reg.metric("encode_gbps").read(run) is None
    assert reg.metric("compressed_ratio").read(run) is None
    assert reg.metric("setup_s").read(run) == 9.0
    for name in ("k1.roofline", "idle_share.decode", "block_api.host_us.decode", "k2.roofline"):
        assert reg.metric(name).read(run) is None, name  # no trace
    run.trace = timeline.Trace(0.0, 1e6, [("void (anonymous namespace)::decode_blocks_kernel(int)", 0.0, 5e5)], [])
    assert reg.metric("k1.roofline").read(run) == pytest.approx(
        100 * roofline.decode_bytes(2_000_000_000, 100, 4_000_000_000) / 3.35e12 / 0.5)
    assert reg.metric("idle_share.decode").read(run) == pytest.approx(50.0)
    assert reg.metric("block_api.host_us.decode").read(run) == pytest.approx(200.0)
    assert reg.metric("k2.roofline").read(run) is None
    run.trace = timeline.Trace(0.0, 1e6, [("other_kernel", 0.0, 5e5)], [])
    assert reg.metric("k1.roofline").read(run) is None
