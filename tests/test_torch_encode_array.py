"""The port's array encoder (``snappy_tpu_torch/ops/encode_array.py``) and
``encoder="array"`` on the write paths, against snappy_tpu as it runs on a
CPU host: there ``select.block_encoder`` and ``encode_xla._best_encoder``
pick ``encode_xla``, so the reference runs unpatched.

Inputs are the corpus and rows made from seeds with numpy; the port runs on
the CPU. Tolerance: exact (``olens`` and ``out[:olen]``, or whole streams),
since the outputs are bytes.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.native import runtime as ref_nat
from snappy_tpu.ops import encode_xla
from snappy_tpu.ops import host as ref_host
from snappy_tpu.ops import primitives as ref_primitives
from snappy_tpu.parallel import distributed as ref_distributed
from snappy_tpu.parallel import streaming as ref_streaming
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.cpu import oracle
from snappy_tpu_torch.native import libsnappy
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import cuda_encode, encode_array, primitives, route, select
from snappy_tpu_torch.ops import host as port_host
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT, ENC_PAD
from snappy_tpu_torch.parallel import distributed, multihost, streaming
from snappy_tpu_torch.parallel import host as port_framed_host
from snappy_tpu_torch.tools.profile_encode import collision_block

from conftest import CORPUS_SMALL, read_testdata
from torch_helpers import config_from_reference, one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BLOCK = 1 << 16
# The 13 inputs of tests/test_encode_xla.py::test_simple_roundtrip.
SIMPLE = [
    b"",
    b"a",
    b"ab",
    b"abc",
    b"aab",
    b"hello hello hello hello world world",
    b"x" * 16,
    b"x" * 1000,
    b"ab" * 5000,
    b"abcd" * 16384,
    b"aaaaaaa" + b"b" * 2047 + b"aaaaa" + b"abc",
    b"aaaaaaa" + b"b" * 65536 + b"aaaaa" + b"abc",
    bytes(range(256)) * 16,
]
# tests/test_encode_xla.py::test_multi_block_stream: 17 blocks, more than
# one routing chunk.
MULTI_BLOCK = (b"The quick brown fox jumps over the lazy dog. " * 40000)[: 17 * BLOCK + 123]


def blocks_of(data: bytes, block_size: int = BLOCK) -> list[bytes]:
    return [data[i : i + block_size] for i in range(0, len(data), block_size)]


def max_blowup() -> bytes:
    """tests/test_encode_xla.py::test_max_blowup's data (its seed)."""
    words = np.random.default_rng(0x5EED).integers(0, 1 << 32, size=20000, dtype=np.uint32)
    return np.concatenate([words, words[::-1]]).view(np.uint8).tobytes()


def over_the_cap() -> bytes:
    """Seeded random bytes repeated, so that matches run past the 512-byte
    cap of the extension, at short and long offsets."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    return a + b + a + b * 5 + a[:700] + rng.integers(0, 256, 9000, dtype=np.uint8).tobytes() + a


# The rows of the 64 KiB batch, by case; the batch is padded with blen-0 rows.
ROW_CASES = {
    "corpus_small": [b for name in CORPUS_SMALL for b in blocks_of(read_testdata(name))],
    "simple_roundtrip": [b for raw in SIMPLE for b in blocks_of(raw)],
    "over_the_cap": [over_the_cap()],
    "max_blowup": blocks_of(max_blowup()),
    "x_65536": [b"x" * BLOCK],
    "collision_block": [collision_block()],
}
ROWS_64K = 40
# 4096-byte rows: text, a jpeg slice, a run, nothing.
ROWS_4K = blocks_of(read_testdata("html")[:20000], 4096) + [read_testdata("fireworks.jpeg")[:4096], b"z" * 4096, b""]


def batch(rows: list[bytes], n_rows: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    buf = np.zeros((n_rows, width), np.uint8)
    blens = np.zeros(n_rows, np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = np.frombuffer(r, np.uint8)
        blens[i] = len(r)
    return buf, blens


def reference_rows(buf: np.ndarray, blens: np.ndarray):
    out, olens = encode_xla.encode_blocks_jit(len(buf))(jnp.asarray(buf), jnp.asarray(blens))
    return np.asarray(out), np.asarray(olens)


def port_rows(buf: np.ndarray, blens: np.ndarray):
    out, olens = encode_array.encode_blocks(torch.from_numpy(buf), torch.from_numpy(blens), 2)
    return out.numpy(), olens.numpy()


def assert_same_rows(ref, port, rows: range) -> None:
    (r_out, r_olens), (p_out, p_olens) = ref, port
    for i in rows:
        assert p_olens[i] == r_olens[i], f"row {i}: olen {p_olens[i]} against {r_olens[i]}"
        assert p_out[i, : p_olens[i]].tobytes() == r_out[i, : r_olens[i]].tobytes(), f"row {i}"


@pytest.fixture(scope="module")
def rows_64k():
    """Every case's rows in one batch of 64 KiB rows, blen-0 rows after them,
    through both encoders: (ranges by case, reference, port, buf, blens)."""
    rows, ranges = [], {}
    for case, rs in ROW_CASES.items():
        ranges[case] = range(len(rows), len(rows) + len(rs))
        rows += rs
    assert len(rows) < ROWS_64K
    ranges["blen_0_padding"] = range(len(rows), ROWS_64K)
    buf, blens = batch(rows, ROWS_64K, BLOCK + ENC_PAD)
    return ranges, reference_rows(buf, blens), port_rows(buf, blens), buf, blens


@pytest.mark.parametrize("n", [1, 37, 1000, 4097])
def test_reach_from(n):
    """Batched reach_from against the reference's, row by row, on seeded
    strictly increasing maps (n is not a power of two)."""
    rng = np.random.default_rng(n)
    nxt = np.minimum(np.arange(n)[None, :] + rng.integers(1, 12, (3, n)), n).astype(np.int32)
    got = primitives.reach_from(0, torch.from_numpy(nxt), n).numpy()
    for row, want_nxt in zip(got, nxt):
        want = np.asarray(ref_primitives.reach_from(jnp.int32(0), jnp.asarray(want_nxt), n))
        assert (row == want).all()


def test_reach_from_per_row_start():
    rng = np.random.default_rng(1)
    n = 500
    nxt = np.minimum(np.arange(n)[None, :] + rng.integers(1, 5, (2, n)), n).astype(np.int32)
    got = primitives.reach_from(torch.tensor([0, 3]), torch.from_numpy(nxt), n).numpy()
    for row, start in zip(range(2), (0, 3)):
        want = ref_primitives.reach_from(jnp.int32(start), jnp.asarray(nxt[row]), n)
        assert (got[row] == np.asarray(want)).all()


@pytest.mark.parametrize("case", [*ROW_CASES, "blen_0_padding"])
def test_rows_match_encode_xla(rows_64k, case):
    ranges, ref, port, _, _ = rows_64k
    assert len(ranges[case]) > 0
    assert_same_rows(ref, port, ranges[case])


def test_padding_rows_are_empty(rows_64k):
    ranges, _, (out, olens), _, _ = rows_64k
    pad = ranges["blen_0_padding"]
    assert (olens[pad.start :] == 0).all() and not out[pad.start :].any()


def test_zero_past_olens(rows_64k):
    _, _, (out, olens), _, _ = rows_64k
    assert not (out * (np.arange(BLOCK_MAX_OUT)[None, :] >= olens[:, None])).any()


def test_rows_decode(rows_64k):
    _, _, (out, olens), buf, blens = rows_64k
    for i in range(len(blens)):
        stream = bytes(varint.encode32(int(blens[i]))) + out[i, : olens[i]].tobytes()
        assert snappy_tpu_torch.uncompress(stream) == buf[i, : blens[i]].tobytes(), f"row {i}"


def test_output_does_not_depend_on_the_chunk_size(rows_64k, monkeypatch):
    """One row a chunk, then two, give the rows of the whole batch."""
    _, _, (out, olens), buf, blens = rows_64k
    pick = [0, 5, 12, 20, 30, 31]
    for rows in (1, 2):
        monkeypatch.setattr(encode_array, "CHUNK_BYTES", {"cpu": rows * encode_array.ROW_BYTES_PER_BYTE * buf.shape[1]})
        assert encode_array.rows_per_chunk(buf.shape[1], "cpu") == rows
        p_out, p_olens = port_rows(buf[pick], blens[pick])
        assert (p_olens == olens[pick]).all() and (p_out == out[pick]).all()


def test_4096_byte_rows_match_encode_xla():
    """The block size is read from the row width, as the reference does."""
    buf, blens = batch(ROWS_4K, 8, 4096 + ENC_PAD)
    assert_same_rows(reference_rows(buf, blens), port_rows(buf, blens), range(8))


def test_min_profit_is_not_read():
    buf, blens = batch(ROWS_4K[:3], 3, 4096 + ENC_PAD)
    outs = [encode_array.encode_blocks(torch.from_numpy(buf), torch.from_numpy(blens), mp) for mp in (None, 0, 3)]
    assert all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1]) for o in outs)


@pytest.mark.parametrize("bad", [-1, 4097])
def test_blens_outside_the_row_raise(bad):
    buf, blens = batch([b"abc"], 2, 4096 + ENC_PAD)
    blens[1] = bad
    with pytest.raises(ValueError):
        encode_array.encode_blocks(torch.from_numpy(buf), torch.from_numpy(blens))


def test_bad_arguments_raise():
    with pytest.raises(TypeError):
        encode_array.encode_blocks(torch.zeros((2, 100), dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        encode_array.encode_blocks(torch.zeros((2, 100), dtype=torch.uint8), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        encode_array.encode_blocks(torch.zeros((2, (1 << 16) + ENC_PAD + 1), dtype=torch.uint8),
                                   torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("name", CORPUS_SMALL)
def test_raw_matches_reference(name):
    raw = read_testdata(name)
    assert snappy_tpu_torch.compress(raw, backend="torch", device="cpu", encoder="array") == ref_host.compress(raw)


def test_raw_multi_block_stream_matches_reference():
    ours = snappy_tpu_torch.compress(MULTI_BLOCK, backend="torch", device="cpu", encoder="array")
    assert ours == ref_host.compress(MULTI_BLOCK)
    assert snappy_tpu_torch.uncompress(ours, backend="torch", device="cpu") == MULTI_BLOCK


def _unloadable():
    raise OSError("native library cannot load here")


def test_raw_without_the_native_library_matches_reference(monkeypatch):
    """fireworks.jpeg routes no block where neither library loads: both
    packages encode it all with their array encoders."""
    monkeypatch.setattr(nat, "_load", _unloadable)
    monkeypatch.setattr(ref_nat, "_load", _unloadable)
    assert not nat.available() and not ref_nat.available()
    raw = read_testdata("fireworks.jpeg")
    ours = snappy_tpu_torch.compress(raw, backend="torch", device="cpu", encoder="array")
    assert ours == ref_host.compress(raw)
    assert snappy_tpu_torch.uncompress(ours, backend="torch", device="cpu") == raw


# Three blocks: text, a jpeg block (routed to the host), text.
FRAMED_RAW = read_testdata("html")[:BLOCK] + read_testdata("fireworks.jpeg")[:BLOCK] + read_testdata("alice29.txt")[:40000]


@pytest.mark.parametrize(
    "cfg, raw",
    [
        (RefFrameConfig(), FRAMED_RAW),
        (RefFrameConfig(block_size=4096), read_testdata("html")[:30000]),
        (RefFrameConfig(min_profit=1), FRAMED_RAW),
    ],
    ids=["default", "block_size_4096", "min_profit_1"],
)
def test_framed_matches_reference(cfg, raw):
    ours = snappy_tpu_torch.compress_framed(raw, config_from_reference(cfg), device="cpu", encoder="array")
    assert ours == snappy_tpu.compress_framed(raw, cfg)
    assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


def test_mesh_matches_reference():
    """The port over two "cpu" shards against the reference's two-device
    CPU mesh; no block is routed on either. The reference's traced shard
    program is cached by mesh: it is cleared before and after, so that no
    trace of another test's encoder is reused."""
    raw = read_testdata("html_x_4")[: 3 * BLOCK + 777]
    ref_distributed._sharded_encode.cache_clear()
    try:
        ref = snappy_tpu.compress_framed(raw, mesh=ref_distributed.mesh_1d(jax.devices()[:2]))
    finally:
        ref_distributed._sharded_encode.cache_clear()
    ours = snappy_tpu_torch.compress_framed(raw, device="cpu", mesh=distributed.mesh_1d(["cpu"] * 2), encoder="array")
    assert ours == ref
    assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


def test_multihost_matches_reference(tmp_path):
    """Two gloo ranks of ``tools/multihost_run`` with ``--encoder array``,
    two "cpu" shards each, write the reference's 2-device mesh frame."""
    from test_torch_multihost import run_ranks

    raw = read_testdata("html_x_4")[: 3 * BLOCK + 777]
    ref_distributed._sharded_encode.cache_clear()
    try:
        ref = snappy_tpu.compress_framed(raw, mesh=ref_distributed.mesh_1d(jax.devices()[:2]))
    finally:
        ref_distributed._sharded_encode.cache_clear()
    in_path, frame, out = tmp_path / "in.bin", tmp_path / "mh.frame", tmp_path / "mh.out"
    in_path.write_bytes(raw)
    rcs, logs = run_ranks(2, in_path, [frame] * 2, out, "--encoder", "array")
    assert rcs == [0, 0], "\n".join(logs)
    assert frame.read_bytes() == ref
    assert out.read_bytes() == raw


def test_stream_matches_reference():
    raw = read_testdata("html_x_4")[: 5 * BLOCK + 999]
    ref = io.BytesIO()
    ref_streaming.compress_stream(io.BytesIO(raw), ref, blocks_per_frame=2)
    ours = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), ours, device="cpu", blocks_per_frame=2, encoder="array")
    assert len(list(streaming.iter_frames(io.BytesIO(ours.getvalue())))) == 3
    assert ours.getvalue() == ref.getvalue()
    back = io.BytesIO()
    ours.seek(0)
    streaming.uncompress_stream(ours, back, device="cpu")
    assert back.getvalue() == raw


def test_resume_writes_the_stream(tmp_path):
    raw = read_testdata("alice29.txt")[: 3 * BLOCK]
    src, whole, resumed = tmp_path / "in", tmp_path / "whole", tmp_path / "resumed"
    src.write_bytes(raw)
    streaming.compress_file(str(src), str(whole), device="cpu", blocks_per_frame=1, encoder="array")
    data = whole.read_bytes()
    resumed.write_bytes(data[: len(data) // 2])
    streaming.resume_compress_file(str(src), str(resumed), device="cpu", blocks_per_frame=1, encoder="array")
    assert resumed.read_bytes() == data


@pytest.mark.parametrize("name", CORPUS_SMALL)
def test_density_and_decoders(name):
    """No larger than the oracle's greedy parse; decodes through the port's
    "torch" decoder on the CPU, the oracle and, where it is installed,
    libsnappy."""
    raw = read_testdata(name)
    comp = snappy_tpu_torch.compress(raw, backend="torch", device="cpu", encoder="array")
    assert len(comp) <= len(oracle.compress(raw))
    assert snappy_tpu_torch.uncompress(comp, backend="torch", device="cpu") == raw
    assert snappy_tpu_torch.uncompress(comp, backend="cpu") == raw
    if libsnappy.available():
        assert libsnappy.uncompress(comp) == raw


def test_select_by_name():
    for dev in ("cpu", "cuda", torch.device("cuda", 0)):
        assert select.block_encoder(dev, "array") is encode_array.encode_blocks
        assert select.block_encoder(dev, "kernel") is cuda_encode.encode_blocks
        assert select.block_encoder(dev) is cuda_encode.encode_blocks
    with pytest.raises(ValueError):
        select.block_encoder("cpu", "xla")
    with pytest.raises(ValueError):
        select.block_encoder("meta", "array")


KERNEL_RAW = read_testdata("html")[:40000]


def test_kernel_is_the_default():
    cpu2 = distributed.mesh_1d(["cpu"] * 2)
    assert snappy_tpu_torch.compress(KERNEL_RAW, backend="torch", device="cpu", encoder="kernel") == \
        snappy_tpu_torch.compress(KERNEL_RAW, backend="torch", device="cpu")
    assert snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu", encoder="kernel") == \
        snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu")
    assert snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu", mesh=cpu2, encoder="kernel") == \
        snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu", mesh=cpu2)
    seqs = []
    for kw in ({"encoder": "kernel"}, {}):
        dst = io.BytesIO()
        streaming.compress_stream(io.BytesIO(KERNEL_RAW), dst, device="cpu", blocks_per_frame=1, **kw)
        seqs.append(dst.getvalue())
    assert seqs[0] == seqs[1]


def test_encoders_write_different_parses():
    """K2's parse and the array parse differ on text; both decode."""
    kernel = snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu")
    array = snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu", encoder="array")
    assert kernel != array
    for f in (kernel, array):
        assert snappy_tpu_torch.uncompress_framed(f, device="cpu") == KERNEL_RAW


def _entry_points(tmp_path):
    src = tmp_path / "in"
    src.write_bytes(KERNEL_RAW)
    buf, blens = port_host.blockify(np.frombuffer(KERNEL_RAW, np.uint8), BLOCK)
    cpu2 = distributed.mesh_1d(["cpu"] * 2)
    return {
        "api.compress": lambda e: snappy_tpu_torch.compress(KERNEL_RAW, backend="torch", device="cpu", encoder=e),
        "host.compress": lambda e: port_host.compress(KERNEL_RAW, device="cpu", encoder=e),
        "route.dispatch_routed": lambda e: route.dispatch_routed(buf, blens, np.zeros(0, np.int64), "cpu", 2, e),
        "compress_framed": lambda e: snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cpu", encoder=e),
        "compress_framed_empty": lambda e: snappy_tpu_torch.compress_framed(b"", device="cpu", encoder=e),
        "compress_framed_mesh": lambda e: snappy_tpu_torch.compress_framed(KERNEL_RAW, mesh=cpu2, encoder=e),
        "dispatch_compress": lambda e: port_framed_host.dispatch_compress(KERNEL_RAW, device="cpu", encoder=e),
        "distributed.compress_blocks": lambda e: distributed.compress_blocks(buf, blens, distributed.mesh_1d(["cpu"]),
                                                                             encoder=e),
        "compress_stream": lambda e: streaming.compress_stream(io.BytesIO(b""), io.BytesIO(), device="cpu",
                                                               encoder=e),
        "compress_file": lambda e: streaming.compress_file(str(src), str(tmp_path / "out"), device="cpu",
                                                           encoder=e),
        "resume_compress_file": lambda e: streaming.resume_compress_file(str(src), str(tmp_path / "out"),
                                                                         device="cpu", encoder=e),
        "multihost.compress_framed": lambda e: multihost.compress_framed(str(src), str(tmp_path / "out"),
                                                                         encoder=e),
    }


@pytest.mark.parametrize(
    "entry",
    ["api.compress", "host.compress", "route.dispatch_routed", "compress_framed",
     "compress_framed_empty", "compress_framed_mesh", "dispatch_compress", "distributed.compress_blocks",
     "compress_stream", "compress_file", "resume_compress_file", "multihost.compress_framed"],
)
def test_unknown_encoder_raises_before_data_moves(entry, tmp_path, monkeypatch):
    def moved(*_):
        raise AssertionError("data moved before the encoder's name was checked")

    for mod in (route, port_framed_host, distributed):
        monkeypatch.setattr(mod, "to_device", moved)
    with pytest.raises(ValueError, match="unknown block encoder"):
        _entry_points(tmp_path)[entry]("xla")


@pytest.mark.parametrize("encoder", select.ENCODERS)
def test_cuda_without_a_card_raises(encoder):
    """No fallback: a write path asked for the card raises without one."""
    if torch.cuda.is_available():
        pytest.fail("this test needs a host without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        snappy_tpu_torch.compress_framed(KERNEL_RAW, device="cuda", encoder=encoder)
