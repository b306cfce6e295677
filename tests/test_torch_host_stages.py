"""The host stages of the framed and stream paths, on the CPU: the batch
packed by torch (``ops.host.pack_batch``, the code that builds the rows on
the card) against the host's row-by-row ``pack_rows``, padding included;
the crcs spread over threads against ``zlib.crc32`` one block at a time,
and their error against the reference's; tickets that hold their results
(``ops.host.HostCopy``) assembled twice. The bytes of whole framed, raw
and stream calls against the reference are held by the other files."""

import zlib

import numpy as np
import pytest
import torch

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.parallel import framed as ref_framed
from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.ops import host as ohost
from snappy_tpu_torch.ops.decode_torch import COMP_PAD
from snappy_tpu_torch.parallel import distributed, framed
from snappy_tpu_torch.parallel import host as phost

BLOCK = 1 << 16

# Ragged stream lengths: (clens, rows).
PACK_CASES = {
    "one block": ([37], 1),
    "one block, padded rows": ([37], 5),
    "clen 0": ([0, 12, 0], 3),
    "all clen 0": ([0, 0], 4),
    "empty rows only": ([], 3),
    "widest row": ([5, BLOCK * 6 + 1, 9], 3),
    "width on a 16-byte edge": ([16 - COMP_PAD, 3], 2),
    "seeded ragged": (np.random.default_rng(7).integers(0, 3000, 40).tolist(), 45),
}


def _span(clens, seed=0):
    return np.random.default_rng(seed).integers(0, 256, int(sum(clens)), dtype=np.uint8)


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_batch_rows_equal_pack_rows(case):
    clens, rows = PACK_CASES[case]
    clens = np.array(clens, np.int64)
    ulens = np.arange(len(clens), dtype=np.int64) * 3 + 1
    span = _span(clens)
    comp, d_clens, d_ulens = ohost.pack_batch(span, clens, ulens, rows, "cpu")
    pad = np.zeros(rows - len(clens), np.int64)
    all_clens = np.concatenate([clens, pad])
    want = ohost.pack_rows(span, np.concatenate([[0], np.cumsum(all_clens)[:-1]]), all_clens)
    assert comp.dtype == torch.uint8 and comp.is_contiguous()
    np.testing.assert_array_equal(comp.numpy(), want)
    assert d_clens.dtype == d_ulens.dtype == torch.int32 and d_clens.is_contiguous() and d_ulens.is_contiguous()
    np.testing.assert_array_equal(d_clens.numpy(), all_clens)
    np.testing.assert_array_equal(d_ulens.numpy(), np.concatenate([ulens, pad]))


def test_pack_batch_refuses_a_span_of_another_length():
    with pytest.raises(ValueError, match="span"):
        ohost.pack_batch(np.zeros(5, np.uint8), np.array([3, 3]), np.array([1, 1]), 2, "cpu")


@pytest.mark.parametrize("block_size,n", [(BLOCK, 3), (4096, 17), (1000, 1)])
@pytest.mark.parametrize("rows", ["blocks", "padded"])
def test_frame_batch_rows_equal_pack_rows(block_size, n, rows):
    """A frame's payload starts after its header and index (payload_start >
    0); the rows equal pack_rows's over the frame's bytes."""
    rng = np.random.default_rng(block_size + n)
    raw = (rng.integers(0, 4, block_size * n - 11, dtype=np.uint8) * 61).tobytes()
    frame = snappy_tpu_torch.compress_framed(raw, snappy_tpu_torch.FrameConfig(block_size=block_size), device="cpu")
    idx = framed.parse_index(frame)
    assert idx.payload_start > 0
    n_rows = n if rows == "blocks" else n + 3
    comp, clens, ulens, out_size = phost.frame_batch(frame, idx, None if rows == "blocks" else n_rows)
    c = np.zeros(n_rows, np.int64)
    c[:n] = idx.comp_lens
    starts = idx.payload_start + np.concatenate([[0], np.cumsum(c)[:-1]])
    np.testing.assert_array_equal(comp.numpy(), ohost.pack_rows(np.frombuffer(frame, np.uint8), starts, c))
    assert out_size == block_size and int(ulens.sum()) == len(raw)


def test_block_batch_refuses_an_overlong_stream():
    with pytest.raises(CorruptInputError, match="longer than any valid"):
        phost.block_batch(np.zeros(6 * 10 + 2, np.uint8), np.array([6 * 10 + 2]), np.array([10]), 10, 1)


@pytest.mark.parametrize("arrays", ["one", "mixed", "read-only", "empty"])
def test_stage_on_the_cpu(arrays):
    rng = np.random.default_rng(3)
    given = {
        "one": [rng.integers(0, 256, (3, 40), dtype=np.uint8)],
        "mixed": [rng.integers(0, 256, 77, dtype=np.uint8), np.arange(5, dtype=np.int32), np.arange(3, dtype=np.int64)],
        "read-only": [np.frombuffer(b"abcdef", np.uint8)],
        "empty": [np.zeros(0, np.uint8), np.zeros((0, 4), np.int32)],
    }[arrays]
    got = ohost.stage(given, "cpu")
    assert len(got) == len(given)
    for a, t in zip(given, got):
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 9, 100])
@pytest.mark.parametrize("size", [100, 6000, BLOCK])
@pytest.mark.parametrize("native", [True, False], ids=["native", "zlib"])
def test_crc32s_equal_zlib_block_by_block(n, size, native, monkeypatch):
    """Threads of native calls where the library loads, zlib.crc32 on this
    thread where it does not; blocks of every length mod 8 (the native
    loop's tail) and of no bytes."""
    if native:
        assert framed.nat.available()
    else:
        monkeypatch.setattr(framed.nat, "available", lambda: False)
    data = np.random.default_rng(n * size + 1).integers(0, 256, n * size + n, dtype=np.uint8)
    blocks = [data[i * size : (i + 1) * size - i % 9] for i in range(n)]
    want = [zlib.crc32(b) for b in blocks]
    assert framed.crc32s(blocks) == want
    assert framed.crc32s([b.tobytes() for b in blocks]) == want
    assert framed.crc32s([memoryview(b.tobytes()) for b in blocks]) == want


@pytest.mark.parametrize("offset", [0, 1, 13])
@pytest.mark.parametrize("lengths", ["0-159", "runs of 64 and tails", "long"])
def test_native_crc32_rows_equal_zlib(lengths, offset):
    """Every length below the fold's 64 bytes and around its 16- and
    64-byte steps, and long buffers, at aligned and unaligned starts."""
    ns = {"0-159": range(160), "runs of 64 and tails": [64 * k + t for k in (1, 2, 3, 9) for t in range(0, 20, 3)],
          "long": [4095, 65536, 65537, 123457, 1 << 20]}[lengths]
    data = np.random.default_rng(offset).integers(0, 256, max(ns) + offset, dtype=np.uint8)
    views = [data[offset : offset + n] for n in ns]
    ptrs = np.array([v.ctypes.data for v in views], np.uint64)
    out = np.empty(len(views), np.uint32)
    framed.nat.crc32_rows(ptrs, np.array(list(ns), np.int64), out)
    assert out.tolist() == [zlib.crc32(v) for v in views]


@pytest.mark.parametrize("n", [0, 5, (1 << 20) - 1, 1 << 20, 5 * (1 << 20) + 3])
def test_copy_into_in_runs(n):
    src = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    dst = np.zeros(n, np.uint8)
    ohost.copy_into(dst, src)
    np.testing.assert_array_equal(dst, src)


def _bad_crcs(frame: bytes, blocks) -> bytes:
    idx = framed.parse_index(frame)
    out = bytearray(frame)
    crc_at = framed._HEADER.size + 4 * idx.n_blocks
    for i in blocks:
        out[crc_at + 4 * i] ^= 0x5A
    return bytes(out)


@pytest.mark.parametrize("bad", [(0, 1), (2, 9), (5, 11), (11, 3)])
def test_two_corrupt_blocks_name_the_lower_as_the_reference(bad):
    raw = (np.random.default_rng(5).integers(0, 3, 12 * 4096, dtype=np.uint8) * 85).tobytes()
    frame = _bad_crcs(snappy_tpu_torch.compress_framed(raw, snappy_tpu_torch.FrameConfig(block_size=4096),
                                                       device="cpu"), bad)
    want = f"crc mismatch in block {min(bad)}"
    blocks = [raw[i : i + 4096] for i in range(0, len(raw), 4096)]
    with pytest.raises(snappy_tpu.CorruptInputError) as ref:
        ref_framed.verify_crcs(ref_framed.parse_index(frame), blocks)
    assert str(ref.value) == want
    with pytest.raises(CorruptInputError) as got:
        framed.verify_crcs(framed.parse_index(frame), blocks)
    assert str(got.value) == want
    with pytest.raises(CorruptInputError) as got:
        snappy_tpu_torch.uncompress_framed(frame, device="cpu")
    assert str(got.value) == want
    with pytest.raises(snappy_tpu.CorruptInputError) as ref:
        snappy_tpu.uncompress_framed(frame)
    assert str(ref.value) == want


@pytest.mark.parametrize("first", [0, 3])
def test_verify_crcs_range_names_the_frame_block(first):
    raw = bytes(range(256)) * 16 * 6
    frame = _bad_crcs(snappy_tpu_torch.compress_framed(raw, snappy_tpu_torch.FrameConfig(block_size=4096),
                                                       device="cpu"), [4, 5])
    idx = framed.parse_index(frame)
    blocks = [raw[i : i + 4096] for i in range(first * 4096, len(raw), 4096)]
    with pytest.raises(CorruptInputError, match="crc mismatch in block 4$"):
        framed.verify_crcs_range(idx, blocks, first)


def _mesh():
    return distributed.mesh_1d(["cpu"] * 2)


@pytest.mark.parametrize("mesh", [None, "cpu x2"])
@pytest.mark.parametrize("direction", ["compress", "uncompress"])
def test_a_ticket_assembled_twice_gives_the_same_bytes(direction, mesh):
    raw = (bytes(range(200)) * 700)[: 2 * BLOCK + 321]
    mesh = None if mesh is None else _mesh()
    frame = snappy_tpu_torch.compress_framed(raw, device="cpu", mesh=mesh)
    if direction == "compress":
        ticket = phost.dispatch_compress(raw, device="cpu", mesh=mesh)
        assert phost.assemble_compress(ticket) == phost.assemble_compress(ticket) == frame
    else:
        ticket = phost.dispatch_uncompress(frame, device="cpu", mesh=mesh)
        assert phost.assemble_uncompress(ticket) == phost.assemble_uncompress(ticket) == raw


def test_host_copy_holds_cpu_tensors_and_one_device_only():
    out, ok = torch.arange(6, dtype=torch.uint8).reshape(2, 3), torch.tensor([True, False])
    c = ohost.HostCopy([out, ok])
    for _ in range(2):
        got = c.wait()
        np.testing.assert_array_equal(got[0], out.numpy())
        np.testing.assert_array_equal(got[1], ok.numpy())
    with pytest.raises(ValueError, match="one device"):
        ohost.HostCopy([out, torch.zeros(1, device="meta")])


def test_to_host_is_one_copy_a_shard():
    mesh = _mesh()
    buf, blens = ohost.blockify(np.frombuffer(bytes(range(256)) * 300, np.uint8), 1 << 14, 6)
    copies = distributed.to_host(distributed.compress_blocks(buf, blens, mesh))
    assert len(copies) == mesh.size
    streams = phost.mesh_streams(copies, 5)
    frame = snappy_tpu_torch.compress_framed(bytes(range(256)) * 300,
                                             snappy_tpu_torch.FrameConfig(block_size=1 << 14), mesh=mesh)
    idx = framed.parse_index(frame)
    assert [len(s) for s in streams] == idx.comp_lens.tolist()
    assert b"".join(streams) == frame[idx.payload_start :]
