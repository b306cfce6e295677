"""The port's multi-host drivers (``snappy_tpu_torch/parallel/multihost.py``)
against snappy_tpu's, on the CPU: real process groups over gloo on
localhost, each rank a ``python -m snappy_tpu_torch.tools.multihost_run``
process with two ``"cpu"`` shards, as ``tests/multihost_worker.py`` gives
each JAX process two devices.

A frame written by several processes must be byte-identical to the
single-process mesh frame of the port and to the reference's mesh frame
(K2 patched in on every shard), whatever the split of blocks over
processes, and must decode in both packages; the reference's frame must
decode through the port's multi-host decoder. A mesh whose processes'
devices interleave, and processes that do not share the output file, are
refused.

Tolerance: exact, since the outputs are bytes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.parallel import distributed as ref_distributed
from snappy_tpu_torch.parallel import distributed, multihost

from conftest import read_testdata
from torch_helpers import one_torch_thread, reference_mesh_k2_patched  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 1 << 16
SHARDS_PER_RANK = 2


def words(n_bytes: int) -> bytes:
    """The reference's uneven-split data (tests/test_multihost.py)."""
    rng = np.random.RandomState(13)
    ws = [rng.randint(0, 256, rng.randint(4, 17)).astype("uint8").tobytes() for _ in range(64)]
    return b"".join(ws[rng.randint(0, 64)] for _ in range(n_bytes // 8))[:n_bytes]


# (process count, data): the reference's cases, and an empty file.
CASES = {
    "2-urls-html": (2, lambda: read_testdata("urls.10K") + read_testdata("html_x_4")),
    "2-odd-tail": (2, lambda: words(5 * BLOCK + 777)),  # odd block count, partial tail block
    "4-ten-blocks": (4, lambda: words(9 * BLOCK + 3000)),  # one process partial, the last none
    "4-three-blocks": (4, lambda: words(3 * BLOCK)),  # fewer blocks than processes
    "2-empty": (2, lambda: b""),
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(nprocs, in_path, frame_paths, out_path, *extra, shards=None):
    """Start ``nprocs`` ranks of the tool (rank r writes ``frame_paths[r]``)
    and wait for all; returns their exit codes and outputs."""
    port = free_port()
    # One torch thread a rank: the host is shared with other test workers.
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    shards = shards or [SHARDS_PER_RANK] * nprocs
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "snappy_tpu_torch.tools.multihost_run", f"127.0.0.1:{port}", str(nprocs),
             str(rank), str(in_path), str(frame_paths[rank]), str(out_path), "--device", "cpu",
             "--local-shards", str(shards[rank]), "--timeout", "60", *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(nprocs)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


@pytest.fixture(scope="module")
def cases():
    """Each case's data and the reference's mesh frame of it (8 shards, K2)."""
    out = {}
    with reference_mesh_k2_patched():
        for name, (nprocs, make) in CASES.items():
            raw = make()
            out[name] = (nprocs, raw, snappy_tpu.compress_framed(raw, mesh=ref_distributed.mesh_1d()))
    return out


@pytest.mark.parametrize("case", CASES)
def test_frame_matches_single_process_and_reference(case, cases, tmp_path):
    nprocs, raw, ref_frame = cases[case]
    in_path, frame, out = tmp_path / "in.bin", tmp_path / "mh.frame", tmp_path / "mh.out"
    in_path.write_bytes(raw)
    rcs, logs = run_ranks(nprocs, in_path, [frame] * nprocs, out)
    assert rcs == [0] * nprocs, "\n".join(logs)
    assert out.read_bytes() == raw
    got = frame.read_bytes()
    single = snappy_tpu_torch.compress_framed(raw, mesh=distributed.mesh_1d(["cpu"] * SHARDS_PER_RANK * nprocs))
    assert got == single
    assert got == ref_frame
    assert snappy_tpu.uncompress_framed(got) == raw


def test_reference_frame_decodes_through_multihost(cases, tmp_path):
    """The reference's mesh frame of 10 blocks, decoded by 4 processes."""
    nprocs, raw, ref_frame = cases["4-ten-blocks"]
    frame, out = tmp_path / "ref.frame", tmp_path / "out.bin"
    frame.write_bytes(ref_frame)
    rcs, logs = run_ranks(nprocs, tmp_path / "unused", [frame] * nprocs, out, "--decode-only")
    assert rcs == [0] * nprocs, "\n".join(logs)
    assert out.read_bytes() == raw


def test_unshared_filesystem_fails_loudly(tmp_path):
    """Ranks that write different files (per-host local disks) both fail:
    rank 1 finds no header, rank 0 cannot decode rank 1's slice."""
    raw = words(3 * BLOCK + 99)
    in_path = tmp_path / "in.bin"
    in_path.write_bytes(raw)
    rcs, logs = run_ranks(2, in_path, [tmp_path / "rank0.frame", tmp_path / "rank1.frame"], tmp_path / "out")
    assert all(rc != 0 for rc in rcs), "\n".join(logs)
    for log in logs:
        assert "shared" in log, log


def test_unequal_device_counts_are_refused(tmp_path):
    in_path = tmp_path / "in.bin"
    in_path.write_bytes(words(BLOCK))
    rcs, logs = run_ranks(2, in_path, [tmp_path / "f"] * 2, tmp_path / "out", shards=[2, 1])
    assert all(rc != 0 for rc in rcs), "\n".join(logs)
    for log in logs:
        assert "unequal device counts" in log, log


def test_block_range_rejects_noncontiguous_devices():
    """Process 0 owns mesh positions 0 and 2: refused, as the reference's
    ``_my_block_range`` refuses it; contiguous positions give their range."""
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="contiguous"):
        multihost._my_block_range(8, distributed.Mesh((cpu,) * 4, (0, 1, 0, 1)))
    with pytest.raises(RuntimeError, match="feeds no device"):
        multihost._my_block_range(8, distributed.Mesh((cpu,) * 2, (1, 1)))
    assert multihost._my_block_range(8, distributed.Mesh((cpu,) * 4, (0, 0, 1, 1))) == (0, 4)
    assert multihost._my_block_range(12, distributed.Mesh((cpu,) * 4, (1, 0, 0, 2))) == (3, 9)
