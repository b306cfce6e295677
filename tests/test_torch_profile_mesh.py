"""``tools/profile_mesh.py`` on the CPU, at a small size: every variant runs
in every turn and returns its bytes (the check inside the tool), the mesh
variants follow the shard counts asked for, and the command line prints a
line a variant and the JSON record. Times on the CPU are host times of the
plain versions and are not checked."""

import json

import pytest

from snappy_tpu_torch.tools import profile_mesh

from torch_helpers import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK = 1 << 16


@pytest.fixture(scope="module")
def records():
    return profile_mesh.profile(profile_mesh.corpus_stream(3 * BLOCK + 999), "cpu", [1, 3], 2)


def test_variants_and_turns(records):
    assert [r["variant"] for r in records] == [
        "compress routed", "compress mesh 1", "compress mesh 3", "uncompress routed frame",
        "uncompress mesh frame", "uncompress mesh frame, mesh 1", "uncompress mesh frame, mesh 3",
    ]
    for r in records:
        assert len(r["seconds"]) == 2 and r["min"] == min(r["seconds"]) and r["bytes"] == 3 * BLOCK + 999


def test_a_variant_that_gives_other_bytes_fails(monkeypatch):
    real = profile_mesh.variants

    def broken(raw, device, shards):
        runs = real(raw, device, shards)
        fn, expect = runs["uncompress mesh frame"]
        runs["uncompress mesh frame"] = (lambda: fn()[:-1], expect)
        return runs

    monkeypatch.setattr(profile_mesh, "variants", broken)
    with pytest.raises(RuntimeError, match="uncompress mesh frame gave other bytes"):
        profile_mesh.profile(b"abc" * 1000, "cpu", [2], 1)


def test_command_line(capsys):
    assert profile_mesh.main(["--bytes", "5000", "--shards", "2", "--turns", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("device cpu") and len(lines) == 1 + 5 + 1
    assert [r["variant"] for r in json.loads(lines[-1])["profile_mesh"]][1] == "compress mesh 2"
