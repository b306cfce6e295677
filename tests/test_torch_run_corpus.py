"""``tools/run_corpus.py``, the port's per-file corpus table, on the CPU.

The host columns (the native codec's ratio and libsnappy's) equal what the
reference's bindings give for the same files; the markdown table has one
row a file; the card's columns run on the CPU at 2 blocks a file through
the plain versions, with the array encoder's ratio equal to the
reference's own encoder (``encode_xla``) on the blocks routing leaves to
it. Rates on the CPU are host times and are not checked.

Tolerance: exact, since sizes are counts of bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from snappy_tpu.native import libsnappy as ref_libsnappy
from snappy_tpu.native import runtime as ref_nat
from snappy_tpu.ops import encode_xla
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import route
from snappy_tpu_torch.ops.host import blockify
from snappy_tpu_torch.tools import run_corpus

from conftest import read_testdata

B = 1 << 16


def test_main_on_the_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(run_corpus, "BATCH", 2)
    md = tmp_path / "corpus.md"
    assert run_corpus.main(["--iters", "1", "--device", "cpu", "--md", str(md)]) == 0
    out = capsys.readouterr().out
    rows = [r for r in md.read_text().splitlines() if r.startswith("| ") and not r.startswith("| file")]
    assert [r.split(" | ")[0][2:] for r in rows] == [label for label, _ in run_corpus.FILES]
    assert "\n".join(rows) in out
    for label, name in run_corpus.FILES:
        raw = read_testdata(name)
        assert f"| {label} | {len(raw)} | - | - |" in out  # no card columns on the CPU


@pytest.mark.parametrize("label,name", run_corpus.FILES)
def test_host_row_matches_the_reference(label, name):
    raw = read_testdata(name)
    row = run_corpus.host_row(label, raw, 1)
    assert row["file"] == label and row["size"] == len(raw)
    assert row["ratio_native"] == len(ref_nat.compress(raw)) / len(raw)
    assert row["native_compress"] > 0 and row["native_uncompress"] > 0
    if ref_libsnappy.available():
        hdr = len(varint.encode32(B))
        tiled = run_corpus.tile_blocks(raw, 16)
        assert row["ratio_libsnappy"] == sum(len(ref_libsnappy.compress(b.tobytes())) - hdr for b in tiled) / (16 * B)


@pytest.mark.parametrize("name", ["html", "urls.10K", "fireworks.jpeg"])
def test_device_row_on_the_cpu(name):
    raw = read_testdata(name)
    row = run_corpus.device_row(raw, "cpu", 2)
    blocks = run_corpus.tile_blocks(raw, 2)
    buf, blens = blockify(blocks.reshape(-1), B)
    host_idx = route.host_blocks(buf, blens)
    assert row["blocks_host_routed"] == len(host_idx)
    dev_idx = np.setdiff1d(np.arange(2), host_idx)
    native = sum(len(s) for s in nat.compress_rows(buf, blens, host_idx))
    ref_rows = 0
    if len(dev_idx):
        _, olens = encode_xla.encode_blocks_jit(len(dev_idx))(jnp.asarray(buf[dev_idx]), jnp.asarray(blens[dev_idx]))
        ref_rows = int(np.asarray(olens).sum())
    assert row["ratio_device_array"] == (native + ref_rows) / (2 * B)
    assert 0 < row["ratio_device"] <= 1.01
    assert row["dev_compress"] > 0 and row["dev_uncompress"] > 0
