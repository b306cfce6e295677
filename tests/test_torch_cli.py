"""The port's command-line interface (``python -m snappy_tpu_torch``) on the
CPU: the cases of ``tests/test_cli.py`` on the port, one run as a
subprocess, and files that cross between the two packages' CLIs.

The port's CLI codes the framed and stream formats on ``--device`` (here
``cpu``, the plain versions of its kernels) and raw streams on the host, as
the reference's does. Tolerance: exact, since the outputs are bytes.
"""

import os
import subprocess
import sys

import pytest
import torch

from snappy_tpu.__main__ import main as ref_main
from snappy_tpu_torch.__main__ import main
from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.parallel import framed, streaming

from conftest import read_testdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture
def sample(tmp_path):
    p = tmp_path / "in.txt"
    p.write_bytes(read_testdata("html") * 3)
    return p


@pytest.mark.parametrize("fmt", ["raw", "framed", "stream"])
def test_roundtrip_formats(fmt, sample, tmp_path, capsys):
    comp = tmp_path / f"c.{fmt}"
    out = tmp_path / f"o.{fmt}"
    assert main(["compress", str(sample), str(comp), "--format", fmt, *CPU]) == 0
    assert main(["decompress", str(comp), str(out), *CPU]) == 0
    assert out.read_bytes() == sample.read_bytes()
    assert main(["info", str(comp)]) == 0
    assert str(len(comp.read_bytes())) in capsys.readouterr().out
    assert (comp.read_bytes()[:8] == framed.MAGIC) == (fmt != "raw")


def test_stream_resume(sample, tmp_path):
    comp = tmp_path / "c.snpf"
    out = tmp_path / "o.bin"
    assert main(["compress", str(sample), str(comp), "--format", "stream", *CPU]) == 0
    out.write_bytes(sample.read_bytes()[:1000])  # the output a kill left
    assert main(["decompress", str(comp), str(out), "--resume", *CPU]) == 0
    assert out.read_bytes() == sample.read_bytes()


def test_single_durable_frame_with_torn_tail_raises(tmp_path, capsys):
    """A stream killed while writing its second frame (one durable frame
    and more bytes) raises, and does not decode to the first frame alone;
    ``info`` reports the torn tail."""
    comp = tmp_path / "c.snpf"
    out = tmp_path / "o.bin"
    big = tmp_path / "big.bin"
    big.write_bytes(read_testdata("html") * 24)  # ~2.4 MB: two stream frames
    assert main(["compress", str(big), str(comp), "--format", "stream", *CPU]) == 0
    full = comp.read_bytes()
    assert streaming.scan_durable_frames(str(comp))[1] == 2
    with open(comp, "rb") as f:
        first_end = len(next(streaming.iter_frames(f)))
    comp.write_bytes(full[: first_end + 40])  # one frame and a torn second
    with pytest.raises(CorruptInputError):
        main(["decompress", str(comp), str(out), *CPU])
    capsys.readouterr()
    assert main(["info", str(comp)]) == 0
    said = capsys.readouterr().out
    assert "1 durable frame(s)" in said and "torn tail 40 B" in said


def test_auto_format_small_is_raw(tmp_path):
    comp = tmp_path / "c.auto"
    small = tmp_path / "small.txt"
    small.write_bytes(b"hello world " * 10)
    assert main(["compress", str(small), str(comp)]) == 0
    assert comp.read_bytes()[:8] != framed.MAGIC
    out = tmp_path / "o.auto"
    assert main(["decompress", str(comp), str(out)]) == 0
    assert out.read_bytes() == small.read_bytes()


def test_cuda_without_a_card_raises(sample, tmp_path):
    """``--device`` defaults to cuda, and without a card the framed and
    stream formats raise: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fmt in ("framed", "stream"):
        with pytest.raises(RuntimeError):
            main(["compress", str(sample), str(tmp_path / fmt), "--format", fmt])
    comp = tmp_path / "c.snpf"
    assert main(["compress", str(sample), str(comp), "--format", "framed", *CPU]) == 0
    with pytest.raises(RuntimeError):
        main(["decompress", str(comp), str(tmp_path / "o.bin")])


def test_python_dash_m(sample, tmp_path):
    comp = tmp_path / "c.snpf"
    out = tmp_path / "o.bin"
    assert main(["compress", str(sample), str(comp), "--format", "stream", *CPU]) == 0
    run = subprocess.run(
        [sys.executable, "-m", "snappy_tpu_torch", "decompress", str(comp), str(out), *CPU],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert run.returncode == 0, run.stderr
    assert out.read_bytes() == sample.read_bytes()
    assert run.stdout.startswith(f"{comp}: -> {len(sample.read_bytes())} bytes")


@pytest.mark.parametrize("fmt", ["raw", "framed", "stream"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_cross_between_the_clis(writer, fmt, sample, tmp_path):
    """A file compressed by ``python -m snappy_tpu`` decompresses with the
    port's CLI, and the other way round."""
    comp = tmp_path / f"c.{fmt}"
    out = tmp_path / "o.bin"
    if writer == "reference":
        assert ref_main(["compress", str(sample), str(comp), "--format", fmt]) == 0
        assert main(["decompress", str(comp), str(out), *CPU]) == 0
    else:
        assert main(["compress", str(sample), str(comp), "--format", fmt, *CPU]) == 0
        assert ref_main(["decompress", str(comp), str(out)]) == 0
    assert out.read_bytes() == sample.read_bytes()
