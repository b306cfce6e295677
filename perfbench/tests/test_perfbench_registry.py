"""The benchmark finds its pieces by name, and BENCHMARK.json keeps to the
contract its runs are checked against."""

import json
import re
import shutil

import pytest

from perfbench.registry import ROOT, Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
REG = Registry()


def test_the_pieces_are_found_by_name():
    assert REG.configs() == sorted(c["name"] for c in BENCH["configs"])
    assert set(REG.cells()) >= {w["name"] for w in BENCH["workloads"]}
    assert set(REG.metrics()) >= {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for w in BENCH["workloads"]:
        cell = REG.cell(w["name"])
        assert {"entry", "direction", "depth"} <= set(cell) and w["name"] == f"{w['config']}.{w['traffic']}"
        entry = REG.entry(cell["entry"])
        assert entry.DIRECTION == cell["direction"] == w["traffic"]
        config = REG.config(w["config"])
        assert callable(REG.generator(config["generator"]).generate)


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    shutil.copytree(ROOT, tmp_path / "perfbench", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    root = tmp_path / "perfbench"
    config = json.loads((root / "configs" / "corpus_64k.json").read_text())
    config.update(name="corpus_16k", block_size=16384)
    (root / "configs" / "corpus_16k.json").write_text(json.dumps(config))
    (root / "cells" / "corpus_16k.decode.json").write_text(
        json.dumps({"entry": "decompress_blocks", "direction": "decode", "depth": 3}))
    (root / "metrics" / "rows_a_batch.py").write_text(
        'UNIT = "rows"\nBETTER = "higher"\nSOURCE = "host_clock"\n\n\ndef read(run):\n    return run.rows / run.batches\n')
    reg = Registry(root)
    assert "corpus_16k.decode" in reg.cells() and "corpus_16k" in reg.configs() and "rows_a_batch" in reg.metrics()
    assert reg.cell("corpus_16k.decode")["depth"] == 3
    assert reg.config("corpus_16k")["block_size"] == 16384
    assert reg.metric("rows_a_batch").UNIT == "rows"
    assert REG.cells() == sorted(p.stem for p in (ROOT / "cells").glob("*.json"))


def test_missing_pieces_are_named():
    with pytest.raises(KeyError, match="no_such"):
        REG.cell("no_such.cell")
    with pytest.raises(KeyError, match="no_such"):
        REG.workload("no_such.cell")


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_each_metric_file_agrees_with_benchmark_json(kind):
    for m in BENCH[kind]:
        reader = REG.metric(m["name"])
        assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (m["unit"], m["better"], m["source"]), m["name"]
        if kind == "per_layer":
            assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"]), m["name"]
        assert callable(reader.read)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT.parent / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert json.loads((ROOT.parent / c["file"]).read_text())["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"] and "\t" not in c["source"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and len(w["why"]) <= 200
        reports = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers and all(m["moves"] in {r["name"] for r in reports} for m in layers)
