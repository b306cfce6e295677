"""The port's mesh drivers (``snappy_tpu_torch/parallel/distributed.py`` and
the ``mesh=`` argument of ``host.py`` and ``streaming.py``) against
snappy_tpu's, on the CPU.

The port's mesh is a list of ``"cpu"`` devices, each running the plain
versions of the kernels; the reference's is ``mesh_1d()`` over the 8
virtual CPU devices of ``conftest.py``, with K2 (interpret mode,
``contest=False``) patched in on every shard where a TPU would select it.
Neither mesh path routes a block, so their frames must be byte-identical,
and a frame must not depend on how many shards made it.

Tolerance: exact, since the outputs are bytes.
"""

import functools
import io

import numpy as np
import pytest
import torch

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.parallel import distributed as ref_distributed
from snappy_tpu.parallel import framed as ref_framed
from snappy_tpu.parallel import streaming as ref_streaming
from snappy_tpu_torch.core.config import FrameConfig
from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.ops import cuda_decode, cuda_encode
from snappy_tpu_torch.ops.decode_torch import COMP_PAD
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT, ENC_PAD
from snappy_tpu_torch.parallel import distributed, framed, streaming
from snappy_tpu_torch.tools import dryrun_multichip

from conftest import read_testdata
from torch_helpers import one_torch_thread, reference_mesh_k2_patched  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK = 1 << 16

# (raw bytes, block size) of each case: 7 blocks with a short last one, a
# jpeg (incompressible: the single-device path routes both its blocks to
# the host, the mesh path does not), nothing, a partial tail block, and
# 4 KiB blocks.
CASES = {
    "html_x_4": (read_testdata("html_x_4"), BLOCK),
    "fireworks.jpeg": (read_testdata("fireworks.jpeg"), BLOCK),
    "empty": (b"", BLOCK),
    "partial-tail": (read_testdata("urls.10K")[: 2 * BLOCK + 1234], BLOCK),
    "block-4096": (read_testdata("html")[:30000], 4096),
}
SHARDS = [1, 2, 3, 4, 8]
# The streaming case: 6 blocks in frames of 2.
STREAM_RAW = read_testdata("html_x_4")[: 5 * BLOCK + 777]


def cpu_mesh(n: int):
    return distributed.mesh_1d(["cpu"] * n)


@functools.cache
def port_frame(case: str, shards: int = 4) -> bytes:
    raw, bs = CASES[case]
    return snappy_tpu_torch.compress_framed(raw, FrameConfig(block_size=bs), mesh=cpu_mesh(shards))


def batch(raw: bytes, nb: int):
    """``raw`` cut into ``nb`` rows of the block encoder, as
    ``__graft_entry__.py::dryrun_multichip`` cuts it."""
    buf = np.zeros((nb, BLOCK + ENC_PAD), np.uint8)
    blens = np.zeros(nb, np.int32)
    inp = np.frombuffer(raw, np.uint8)
    per = -(-len(inp) // nb)
    for i in range(nb):
        c = inp[i * per : (i + 1) * per]
        buf[i, : len(c)] = c
        blens[i] = len(c)
    return buf, blens


GATHER_BATCH = batch(read_testdata("alice29.txt")[: 5 * 20000], 8)


@pytest.fixture(scope="module")
def ref():
    """What the reference writes with K2 on each of its 8 shards: the mesh
    frame of every case, the frame sequence of STREAM_RAW, and the gathered
    encode of GATHER_BATCH. One patch for all, so that each shape compiles
    once."""
    mesh = ref_distributed.mesh_1d()
    with reference_mesh_k2_patched():
        frames = {
            case: snappy_tpu.compress_framed(raw, RefFrameConfig(block_size=bs), mesh=mesh)
            for case, (raw, bs) in CASES.items()
        }
        seq = io.BytesIO()
        ref_streaming.compress_stream(io.BytesIO(STREAM_RAW), seq, blocks_per_frame=2, mesh=mesh)
        out, olens = ref_distributed.compress_blocks(*GATHER_BATCH, mesh, gather=True)
    return {"frames": frames, "stream": seq.getvalue(), "gather": (np.asarray(out), np.asarray(olens))}


@pytest.fixture(scope="module")
def ref_frames(ref):
    return ref["frames"]


@pytest.mark.parametrize("case", CASES)
def test_mesh_frame_matches_reference(case, ref_frames):
    assert port_frame(case) == ref_frames[case]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_mesh_frame_does_not_depend_on_the_shard_count(case, shards):
    assert port_frame(case, shards) == port_frame(case, 1)


def test_mesh_path_routes_no_block(ref_frames):
    """fireworks.jpeg: the single-device frame routes its blocks to the
    host encoder, the mesh frame encodes them with the block encoder, as
    the reference's two paths do; both decode."""
    raw, _ = CASES["fireworks.jpeg"]
    routed = snappy_tpu_torch.compress_framed(raw, device="cpu")
    assert port_frame("fireworks.jpeg") != routed
    assert ref_frames["fireworks.jpeg"] != snappy_tpu.compress_framed(raw)
    for f in (routed, port_frame("fireworks.jpeg")):
        assert snappy_tpu_torch.uncompress_framed(f, device="cpu") == raw


@pytest.mark.parametrize("case", CASES)
def test_mesh_round_trip_through_both_packages(case, ref_frames):
    raw, _ = CASES[case]
    ours = port_frame(case)
    for shards in (1, 3, 4):
        assert snappy_tpu_torch.uncompress_framed(ours, mesh=cpu_mesh(shards)) == raw
        assert snappy_tpu_torch.uncompress_framed(ref_frames[case], mesh=cpu_mesh(shards)) == raw
    assert snappy_tpu.uncompress_framed(ours, mesh=ref_distributed.mesh_1d()) == raw


def test_mesh_decode_refuses_a_damaged_frame():
    frame = bytearray(port_frame("html_x_4"))
    idx = framed.parse_index(bytes(frame))
    s, e = idx.block_ranges()[5]
    frame[s:e] = b"\xff" * (e - s)
    with pytest.raises(CorruptInputError, match="block 5"):
        snappy_tpu_torch.uncompress_framed(bytes(frame), mesh=cpu_mesh(3))


def test_gather_equals_the_shards_and_the_reference(ref):
    """gather=True gives every device of the mesh the whole result, equal
    to the shards of gather=False joined, and to the reference's gathered
    encode; likewise the decode, which gives the input back."""
    raw = read_testdata("alice29.txt")[: 5 * 20000]
    buf, blens = GATHER_BATCH
    mesh = distributed.mesh_1d(["cpu"] * 4)
    outs, olens = distributed.compress_blocks(buf, blens, mesh, gather=True)
    s_outs, s_olens = distributed.compress_blocks(buf, blens, mesh)
    assert len(outs) == len(olens) == mesh.size and [len(o) for o in s_outs] == [2] * 4
    for o, n in zip(outs, olens):
        assert torch.equal(o, torch.cat(s_outs)) and torch.equal(n, torch.cat(s_olens))
    r_out, r_olens = ref["gather"]
    assert olens[0].numpy().tolist() == r_olens.tolist()
    for i, n in enumerate(r_olens.tolist()):
        assert outs[0][i, :n].numpy().tobytes() == r_out[i, :n].tobytes()

    comp = np.zeros((8, BLOCK_MAX_OUT + COMP_PAD), np.uint8)
    comp[:, :BLOCK_MAX_OUT] = outs[0].numpy()
    d_outs, d_oks, d_totals = distributed.decompress_blocks(comp, olens[0].numpy(), blens, mesh, BLOCK, gather=True)
    s = distributed.decompress_blocks(comp, olens[0].numpy(), blens, mesh, BLOCK)
    for got, shards in zip((d_outs, d_oks, d_totals), s):
        assert all(torch.equal(g, torch.cat(shards)) for g in got)
    assert bool(d_oks[0].all())
    assert b"".join(d_outs[0][i, : blens[i]].numpy().tobytes() for i in range(8)) == raw


def test_padding_rows_code_to_nothing():
    """The rows a mesh pads with (blen 0; clen = ulen = 0) encode to olen 0
    and decode ok to nothing, all zero, in the wrappers' plain versions."""
    blocks = torch.zeros((3, BLOCK + ENC_PAD), dtype=torch.uint8)
    blocks[0, :5] = torch.tensor(list(b"hello"), dtype=torch.uint8)
    out, olens = cuda_encode.encode_blocks(blocks, torch.tensor([5, 0, 0], dtype=torch.int32), 2)
    assert olens.tolist()[1:] == [0, 0] and not bool(out[1:].any())
    comp = torch.zeros((3, 16 + COMP_PAD), dtype=torch.uint8)
    comp[0, : olens[0]] = out[0, : olens[0]]
    dout, ok, total = cuda_decode.decode_blocks(
        comp, torch.tensor([int(olens[0]), 0, 0], dtype=torch.int32), torch.tensor([5, 0, 0], dtype=torch.int32), 64
    )
    assert ok.tolist() == [True] * 3 and total.tolist() == [5, 0, 0] and not bool(dout[1:].any())
    assert dout[0, :5].numpy().tobytes() == b"hello"


def test_mesh_1d_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snappy_tpu_torch.mesh_1d()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        snappy_tpu_torch.compress_framed(b"abc" * 100, mesh=snappy_tpu_torch.mesh_1d())


def test_mesh_1d_devices():
    mesh = snappy_tpu_torch.mesh_1d(["cpu", "cpu", torch.device("cpu")])
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.ranks == (0, 0, 0) and mesh.axis == distributed.AXIS == ref_distributed.AXIS == "blocks"
    with pytest.raises(ValueError, match="at least one"):
        distributed.mesh_1d([])
    with pytest.raises(ValueError, match="no block codec"):
        distributed.mesh_1d(["meta"])


@pytest.mark.parametrize("n_devices", [1, 3, 4, 8])
def test_pad_block_count(n_devices):
    for n in range(0, 20):
        assert distributed.pad_block_count(n, n_devices) == ref_distributed.pad_block_count(n, n_devices)


def test_compress_blocks_refusals():
    buf, blens = batch(b"abcd" * 100, 3)
    with pytest.raises(ValueError, match="do not split"):
        distributed.compress_blocks(buf, blens, cpu_mesh(2))
    foreign = distributed.Mesh((torch.device("cpu"),) * 2, (0, 1))
    with pytest.raises(ValueError, match="other processes"):
        distributed.decompress_blocks(np.zeros((2, 8), np.uint8), np.zeros(2), np.zeros(2), foreign, 64)


def test_parse_index_without_payload():
    """``require_payload=False`` reads the header and index of a frame whose
    payload is not in the buffer, as the reference's does; the index itself
    must still be whole."""
    frame = port_frame("html_x_4")
    idx = framed.parse_index(frame)
    head = frame[: idx.payload_start]
    with pytest.raises(CorruptInputError, match="payload truncated"):
        framed.parse_index(head)
    part = framed.parse_index(head, require_payload=False)
    ref = ref_framed.parse_index(head, require_payload=False)
    for got in (part, ref):
        assert got.payload_start == idx.payload_start and got.block_ranges() == idx.block_ranges()
        assert got.crcs.tolist() == idx.crcs.tolist()
    with pytest.raises(CorruptInputError, match="index truncated"):
        framed.parse_index(head[:-1], require_payload=False)


def test_streaming_with_a_mesh_matches_reference(tmp_path, ref):
    """compress_stream(mesh=) writes the reference's frame sequence; the
    file helpers and both resumes take the mesh too."""
    raw = STREAM_RAW
    mesh = cpu_mesh(3)
    ours = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), ours, blocks_per_frame=2, mesh=mesh)
    assert ours.getvalue() == ref["stream"]
    out = io.BytesIO()
    assert streaming.uncompress_stream(io.BytesIO(ref["stream"]), out, mesh=mesh) == len(raw)
    assert out.getvalue() == raw

    src, full, back = tmp_path / "in.bin", tmp_path / "full.snpf", tmp_path / "out.bin"
    src.write_bytes(raw)
    streaming.compress_file(str(src), str(full), blocks_per_frame=2, mesh=mesh)
    assert full.read_bytes() == ours.getvalue()
    full.write_bytes(ours.getvalue()[: len(ours.getvalue()) // 2])
    assert streaming.resume_compress_file(str(src), str(full), blocks_per_frame=2, mesh=mesh) == len(ours.getvalue())
    assert full.read_bytes() == ours.getvalue()
    back.write_bytes(raw[: BLOCK + 5])
    assert streaming.resume_uncompress_file(str(full), str(back), mesh=mesh) == len(raw)
    streaming.uncompress_file(str(full), str(back), mesh=mesh)
    assert back.read_bytes() == raw


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip(n, capsys):
    assert dryrun_multichip.main([str(n), "--device", "cpu"]) == 0
    assert f"dryrun_multichip({n})" in capsys.readouterr().out
    assert dryrun_multichip.mesh_devices(n, "cpu") == [torch.device("cpu")] * n
