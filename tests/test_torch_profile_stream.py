"""``tools/profile_stream.py`` on the CPU, at a small size: the four turns
of each direction agree byte for byte, the stage spans nest inside their
calls, and the timed functions are put back afterwards. Times on the CPU
are host times of the plain versions and are not checked."""

import pytest

from snappy_tpu_torch.ops import route
from snappy_tpu_torch.parallel import framed
from snappy_tpu_torch.parallel import host as phost
from snappy_tpu_torch.tools import profile_stream

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
    for r in (r for r in records if r["direction"] == direction):
        spans = r["spans"]
        parent = f"dispatch_{direction}"
        stages = [v for k, v in spans.items() if k.startswith(parent + ".")]
        assert len(stages) >= 3
        assert sum(stages) <= spans[parent] <= r["seconds"]
        assert spans[f"assemble_{direction}"] <= r["seconds"]
        assert not any(k.endswith(".wait") for k in spans)  # no card, no wait
        assert r["io_and_rest"] == pytest.approx(r["seconds"] - spans[parent] - spans[f"assemble_{direction}"])


def test_timed_functions_restored(records):
    assert phost.dispatch_compress.__module__ == phost.__name__
    assert route.host_blocks.__module__ == route.__name__
    assert framed.verify_crcs.__module__ == framed.__name__
    assert phost.block_decoder.__name__ == "block_decoder"


def test_main_prints_a_line_a_run(capsys):
    assert profile_stream.main(["--bytes", str(BLOCK + 7), "--blocks-per-frame", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 10 and lines[-1].startswith('{"profile_stream": [')
