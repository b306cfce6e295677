"""``tools/bench.py``, the port's bench, on the CPU at a small size.

Its corpus stream and stream packing give bench.py's bytes and arrays; its
hostile stream decodes through the reference's windowed decoder and the
port's raw path to the bytes it expects; each stage of the card's branch
runs on the CPU (the plain versions of K1, K2 and K3) at 4 blocks a batch
with bench.py's record keys; a damaged stream fails its gate before any
timing; ``main()`` prints the stages line and then the headline. Times on
the CPU are host times of the plain versions and are not checked.

Tolerance: exact, since the outputs are bytes.
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from snappy_tpu.native import libsnappy as ref_libsnappy
from snappy_tpu.ops import decode_xla
from snappy_tpu_torch import uncompress
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops.decode_torch import COMP_PAD
from snappy_tpu_torch.tools import bench
from snappy_tpu_torch.utils.metrics import Metrics

B = 1 << 16
CPU = torch.device("cpu")
BATCH = 4
# bench.py's keys for each stage record (bench.py:184-568).
KEYS = {
    "ratio_libsnappy": {"compressed_ratio"},
    "ratio_device": {"compressed_ratio", "blocks_host_routed"},
    "encode": {"gbps_per_chip", "gbps_at_median", "seconds_per_batch", "timing", "kernel"},
    "decode_own": {"gbps_per_chip", "seconds_per_batch", "rounds_ms", "hbm_roofline_frac", "kernel"},
    "decode_own_r4control": {"gbps_per_chip", "seconds_per_batch", "vs_r4_same_run", "kernel"},
    "decode_own_autotuned": {"gbps_per_chip", "picked"},
    "decode_foreign": {"gbps_per_chip", "picked", "per_kernel_gbps", "hbm_roofline_frac", "kernel"},
    "decode_windowed_fallback": {"bytes", "gbps", "note"},
    "large_device": {"bytes", "compress_gbps", "uncompress_gbps", "uncompress_roofline_frac", "note"},
    "stream_large": {"bytes", "ratio", "compress_gbps", "uncompress_gbps", "uncompress_roofline_frac",
                     "blocks_per_frame", "retries"},
    "scaling_model": {"collective_share", "model_scaling_efficiency", "source"},
}
# Off the card bench.py's decode_own and decode_foreign are its time_decode record.
TIME_DECODE = {"gbps_per_chip", "gbps_at_median", "seconds_per_batch", "timing", "hbm_roofline_frac", "kernel"}
TIMING = {"min", "median", "n", "spread"}
HEADLINE = {"metric", "value", "unit", "vs_baseline", "vs_target"}


@pytest.fixture(scope="module")
def ref_bench():
    """The repository's bench.py. Importing it points jax's compilation
    cache at the repository's .jax_cache; the tests after these run with
    the settings they had before."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield importlib.import_module("bench")
    for k, v in before.items():
        jax.config.update(k, v)


@pytest.fixture(scope="module")
def raw():
    return bench.corpus_stream(BATCH * B)


def records(metrics):
    return {r["stage"]: r for r in metrics.results}


def assert_keys(rec):
    assert KEYS[rec["stage"]] <= set(rec), rec
    if "timing" in rec:
        assert set(rec["timing"]) == TIMING


@pytest.mark.parametrize("target", [1000, 200_000, 3 * B + 17, 8 << 20])
def test_corpus_stream_is_bench_py_s(ref_bench, target):
    assert bench.corpus_stream(target) == ref_bench.corpus_stream(target)


def test_pack_streams_is_bench_py_s(ref_bench, raw):
    streams = bench.host_streams(raw, BATCH)
    ours = bench.pack_streams(streams, COMP_PAD)
    theirs = ref_bench.pack_streams(streams, COMP_PAD)
    assert ours[0] == theirs[0]
    for a, b in zip(ours[1:], theirs[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_hostile_stream():
    stream, expect = bench.hostile_stream(300_000)
    ulen, hdr = varint.parse32(np.frombuffer(stream, np.uint8), 0)
    assert ulen == len(expect) == 200_000 + 64 * ((300_000 - 200_000) // 64)
    assert nat.scan_blocks(stream[hdr:], ulen) is None
    assert decode_xla.decode_raw_windowed(np.frombuffer(stream, np.uint8), ulen, hdr) == expect
    assert uncompress(stream, backend="torch", device="cpu") == expect


def test_card_stages_on_the_cpu(raw):
    """Every stage of the card's branch, one after another as ``bench``
    runs them, with the plain versions."""
    m = Metrics()
    ls_total = bench.libsnappy_stage(raw, m, BATCH)
    streams = bench.encode_stage(raw, CPU, m, BATCH, ls_total)
    gbps, vs_r4 = bench.decode_own_stage(streams, raw, CPU, m)
    bench.decode_foreign_stage(bench.foreign_streams(raw, BATCH), raw, CPU, m)
    bench.windowed_stage(CPU, m, 300_000)
    bench.large_device_stage(CPU, m, 2 * BATCH * B - 1, BATCH)
    bench.stream_stage(CPU, m, 3 * B + 999, 2)
    bench.scaling_stage(CPU, m, BATCH, rounds=1)
    recs = records(m)
    want = set(KEYS) - ({"ratio_libsnappy"} if ls_total is None else set())
    assert set(recs) == want
    for rec in m.results:
        assert_keys(rec)
    for i, s in enumerate(streams):
        assert nat.uncompress(varint.encode32(B) + s) == raw[i * B : (i + 1) * B]
    if ls_total is not None:
        hdr = len(varint.encode32(B))
        assert ls_total == sum(len(ref_libsnappy.compress(raw[i * B : (i + 1) * B])) - hdr for i in range(BATCH))
    assert recs["ratio_device"]["libsnappy_gates"] == ("ran" if ls_total is not None else
                                                       "skipped: libsnappy not installed")
    assert recs["encode"]["timing"]["n"] == 5
    own = recs["decode_own"]
    assert [len(v) for v in own["rounds_ms"].values()] == [3, 3] and set(own["rounds_ms"]) == set(bench.DECODERS)
    assert [len(v) for v in recs["decode_foreign"]["rounds_ms"].values()] == [2, 2]
    assert recs["decode_own_autotuned"]["picked"] in bench.DECODERS
    assert recs["decode_own_autotuned"]["gbps_per_chip"] == gbps
    assert vs_r4 == pytest.approx(own["gbps_per_chip"] / recs["decode_own_r4control"]["gbps_per_chip"])
    # Off the card no roofline is stated.
    assert own["hbm_roofline_frac"] is None and recs["large_device"]["uncompress_roofline_frac"] is None
    assert recs["large_device"]["bytes"] == 2 * BATCH * B
    assert recs["stream_large"]["blocks_per_frame"] == 2 and recs["stream_large"]["retries"] == 0
    assert recs["decode_windowed_fallback"]["decoder"].startswith("plain K1")
    scal = recs["scaling_model"]
    assert scal["shards"] == "4 of one cpu" and 0.0 <= scal["collective_share"] <= 1.0
    assert scal["model_scaling_efficiency"] == 1.0 - scal["collective_share"]


def test_roofline_counts_the_bytes_moved():
    frac = bench.hbm_roofline_frac(1e-3, 1000, 2, 2 * B, torch.device("cuda"))
    assert frac == pytest.approx((1000 + 16 + 2 * B + 10) / 3.35e12 / 1e-3)
    assert bench.hbm_roofline_frac(1e-3, 1000, 2, 2 * B, CPU) is None


@pytest.mark.parametrize("stage", ["decode_own_stage", "time_decode"])
def test_a_damaged_stream_fails_its_gate_before_timing(raw, monkeypatch, stage):
    def timed(*_a, **_k):
        raise AssertionError("timed before the gate")

    monkeypatch.setattr(bench, "time_dispatch_stats", timed)
    streams = bench.host_streams(raw, BATCH)
    bad = bytearray(streams[2])
    bad[len(bad) // 2] ^= 0x55
    streams[2] = bytes(bad)
    m = Metrics()
    with pytest.raises(RuntimeError, match="bench gate"):
        if stage == "time_decode":
            bench.time_decode(streams, raw, CPU, "own", m)
        else:
            bench.decode_own_stage(streams, raw, CPU, m)
    assert m.results == []


def test_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "BATCH", BATCH)
    monkeypatch.setenv("BENCH_BYTES", str(BATCH * B + 5))
    monkeypatch.setenv("BENCH_STREAM_BYTES", str(2 * B + 99))
    report = tmp_path / "report.json"
    assert bench.main(["--device", "cpu", "--report", str(report)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    stages, headline = json.loads(lines[-2]), json.loads(lines[-1])
    names = [r["stage"] for r in stages["stages"]]
    assert names[-4:] == ["decode_own", "decode_foreign", "decode_windowed_fallback", "stream_large"]
    assert set(names) - {"ratio_libsnappy"} == set(names[-4:])
    for rec in stages["stages"]:
        if rec["stage"] in ("decode_own", "decode_foreign"):
            assert TIME_DECODE <= set(rec) and set(rec["timing"]) == TIMING and rec["hbm_roofline_frac"] is None
        else:
            assert_keys(rec)
    assert stages["run"]["device"] == "cpu" and stages["run"]["batch"] == BATCH
    assert set(stages["run"]["launches"]) == {"decode_blocks", "encode_blocks", "decode_blocks_r4"}
    assert HEADLINE <= set(headline) and "vs_r4_same_run" not in headline
    assert headline["metric"] == "device_decompress_throughput" and headline["unit"] == "GB/s/chip"
    assert headline["device"] == "cpu"
    assert headline["vs_baseline"] == pytest.approx(headline["value"] / 0.247)
    assert headline["vs_target"] == pytest.approx(headline["value"] / 10.0)
    saved = json.loads(report.read_text())
    assert saved["run"]["headline"] == headline and saved["results"] == stages["stages"]


def test_device_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
