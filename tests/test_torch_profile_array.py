"""``tools/profile_array.py`` on the CPU, at a small size: the split times
every stage of the array encoder and counts the end-lane loop's rounds, a
copy of ``encode_array.py`` loads as ``--source`` and runs in turns, a
call that gives other bytes fails, and the command line prints its lines
and the JSON record. Times on the CPU are host times and are not checked."""

import json

import pytest

from snappy_tpu_torch.ops import encode_array
from snappy_tpu_torch.tools import profile_array

from torch_helpers import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK = 1 << 16


@pytest.fixture(scope="module")
def rows():
    return profile_array.device_rows(profile_array.corpus_stream(3 * BLOCK + 999), "cpu")


def test_device_rows_are_the_unrouted_blocks(rows):
    blocks, blens = rows
    assert blocks.shape == (4, BLOCK + encode_array.ENC_PAD) and blens.tolist() == [BLOCK] * 3 + [999]


def test_split_times_every_stage(rows):
    s = profile_array.split(*rows)
    assert set(s["stage_ms"]) == set(profile_array.STAGES)
    assert s["rounds"] == len(s["live_lanes"]) > 0 and all(n > 0 for n in s["live_lanes"])
    inner = sum(s["stage_ms"][k] for k in ("links", "doubling", "end_loop"))
    assert inner <= s["stage_ms"]["extension"] <= s["call_ms"]


def test_split_fails_on_other_bytes(rows, monkeypatch):
    real = encode_array._emit
    calls = []

    def flaky(*a):
        calls.append(1)
        out = real(*a)
        return out if len(calls) == 1 else out ^ 1

    monkeypatch.setattr(encode_array, "_emit", flaky)
    with pytest.raises(RuntimeError, match="other bytes"):
        profile_array.split(*rows)


def test_source_runs_in_turns(rows):
    other = profile_array.load_source(encode_array.__file__)
    assert other is not encode_array and other.__name__ == "snappy_tpu_torch.ops.profiled_source"
    got = profile_array.turns(*rows, {"encode_array": encode_array, "source": other}, 2)
    assert {k: len(v) for k, v in got.items()} == {"encode_array": 2, "source": 2}


def test_command_line(capsys):
    argv = ["--bytes", str(BLOCK + 5000), "--turns", "1", "--device", "cpu", "--source", encode_array.__file__]
    assert profile_array.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device cpu") and len(lines) == 5
    record = json.loads(lines[-1])["profile_array"]
    assert record["rows"] == 2 and set(record["turns_ms"]) == {"encode_array", "source"}
