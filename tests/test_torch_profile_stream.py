"""``tools/profile_stream.py`` on the CPU, at a small size: the four turns
of each direction agree byte for byte, the program's spans nest inside the
calls that the tool names them by, a card's wait is the ticket's own
(``HostCopy.wait``, under the assemble that waits), the counters move by
the blocks and bytes of the run, and nothing records once the tool is
done. Times on the CPU are host times of the plain versions and are not
checked."""

import io
import time

import numpy as np
import pytest
import torch

from snappy_tpu_torch.ops import host as ohost
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT
from snappy_tpu_torch.parallel import framed, streaming
from snappy_tpu_torch.parallel import host as phost
from snappy_tpu_torch.tools import profile_stream
from snappy_tpu_torch.utils import profiling

BLOCK = 1 << 16


@pytest.fixture(scope="module")
def records():
    return profile_stream.profile(profile_stream.corpus_stream(5 * BLOCK + 999), 2, "cpu")


def test_turns_and_frames(records):
    assert [(r["mode"], r["direction"]) for r in records] == [
        (mode, direction)
        for mode in ("pipelined", "serial", "serial", "pipelined")
        for direction in ("compress", "uncompress")
    ]
    assert {r["frames"] for r in records} == {3}
    assert {r["bytes"] for r in records} == {5 * BLOCK + 999}


@pytest.mark.parametrize("direction", ["compress", "uncompress"])
def test_spans_nest(records, direction):
    n_blocks = -(-(5 * BLOCK + 999) // BLOCK)
    for r in (r for r in records if r["direction"] == direction):
        spans, counters = r["spans"], r["counters"]
        parent = f"dispatch_{direction}"
        assert len([k for k in spans if k.startswith(parent + ".")]) >= 3
        calls = sum(v for k, v in spans.items() if k.startswith(("dispatch_", "assemble_")))
        assert 0 < spans[parent] <= calls <= r["seconds"]
        assert spans[f"assemble_{direction}"] <= r["seconds"]
        assert not any(k.endswith(".wait") for k in spans)  # no card, no wait
        io_spans = spans.get("read", 0.0) + spans.get("write", 0.0)
        if r["mode"] == "pipelined":
            assert 0 < io_spans <= r["io_and_rest"]
        else:
            assert io_spans == 0
        assert r["io_and_rest"] == pytest.approx(r["seconds"] - calls)
        assert counters["framed.crc_bytes"] == r["bytes"] and counters["host.staged_bytes"] > 0
        assert counters["trace.spans_dropped"] == 0
        if direction == "compress":
            assert counters["route.host_blocks"] + counters["route.device_blocks"] == n_blocks
        else:
            assert counters["route.host_blocks"] == counters["route.device_blocks"] == 0


def test_recording_ends_with_the_profile(records):
    kept = len(profiling.spans())
    with profiling.trace_annotation("test.after_the_profile") as span:
        assert span is None  # the shared null context: nothing records
    assert len(profiling.spans()) == kept


@pytest.mark.parametrize("direction", ["compress", "uncompress"])
def test_card_wait_is_the_tickets_own(direction, monkeypatch):
    """With a card's event behind each ticket, the wait is the ticket's
    HostCopy.wait, a child of the assemble that waits, named under it;
    nothing synchronises the device."""

    class Event:
        def synchronize(self):
            time.sleep(0.001)

    def no_sync(*_):
        raise AssertionError("the profile synchronised the device")

    init = ohost.HostCopy.__init__

    def with_event(self, tensors):
        init(self, tensors)
        self._event = Event()

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(ohost.HostCopy, "__init__", with_event)
    raw = profile_stream.corpus_stream(BLOCK + 99)
    frame = phost.compress_framed(raw, device="cpu")
    start_ns = time.time_ns()
    with profiling.recording():
        if direction == "compress":
            assert phost.assemble_compress(phost.dispatch_compress(raw, device="cpu")) == frame
        else:
            assert phost.assemble_uncompress(phost.dispatch_uncompress(frame, device="cpu")) == raw
    recorded = [s for s in profiling.spans() if s.start_ns >= start_ns]
    (wait,) = [s for s in recorded if s.name == "host.wait"]
    (assemble,) = [s for s in recorded if s.name == f"framed.assemble_{direction}"]
    assert wait.request == assemble.id and wait.thread == assemble.thread
    stages, _ = profile_stream.stage_seconds(recorded)
    assert [k for k in stages if k.endswith(".wait")] == [f"assemble_{direction}.wait"]
    assert 0.001 <= stages[f"assemble_{direction}.wait"] <= (assemble.end_ns - assemble.start_ns) / 1e9


def test_fetch_choice_moves_whole_rows_or_the_streams():
    raw = profile_stream.corpus_stream(3 * BLOCK)
    got = profile_stream.fetch_choice(raw, 3, "cpu", turns=2)
    frame = phost.compress_framed(raw, device="cpu")
    streams = sum(framed.parse_index(frame).comp_lens.astype(np.int64))
    assert got["rows"] == 3 and got["whole_rows_bytes"] == 3 * BLOCK_MAX_OUT
    assert got["lengths_first_bytes"] == 3 * 4 + streams
    assert got["whole_rows_ms"] > 0 and got["lengths_first_ms"] > 0


def test_busy_share_without_a_card(tmp_path):
    raw = profile_stream.corpus_stream(2 * BLOCK + 5)
    comp = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), comp, device="cpu", blocks_per_frame=1)
    got = profile_stream.busy_share(comp.getvalue(), "cpu", str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    assert got["seconds"] > 0 and got["kernels"] == got["copies"] == 0 and got["busy_share"] == 0


def test_main_prints_a_line_a_run(capsys):
    assert profile_stream.main(["--bytes", str(BLOCK + 7), "--blocks-per-frame", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 13 and lines[-1].startswith('{"profile_stream": [')
    assert lines[-4].startswith("kernel loader: kernels.load ")
    assert lines[-3].startswith("encoded frame's results back") and lines[-2].startswith("uncompress_stream under")
