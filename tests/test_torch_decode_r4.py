"""K3's plain version in the port (``decode_torch.decode_blocks_r4``, reached
through the kernel's wrapper on CPU tensors) against snappy_tpu's pinned
round-4 decoder, K3, in interpret mode, and against decode_xla on the rows
inside K3's envelope.

Tolerance: exact, since the outputs are bytes. ``ok`` must be identical on
every row; ``total`` and ``out`` identical where ``ok``. K3 does not zero a
row that fails, so there the port's row must be all zero instead. The cases
go through two batches, one per output width, because K3 takes seconds to
compile per shape in interpret mode.

K3's envelope is narrower than decode_xla's: an offset of 65,536, a literal
of 65,537 bytes and one byte after the last tag are corrupt to K3 and to
the port's K3, and decoded by decode_xla. A cut copy trailer is corrupt to
K3 and accepted by decode_xla, as for K1 (``test_torch_decode.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snappy_tpu.ops import decode_xla, pallas_decode_r4
from snappy_tpu_torch.ops import cuda_decode_r4, decode_torch
from snappy_tpu_torch.utils import profiling

from conftest import read_testdata
from torch_helpers import copy2, lit, native_block_streams, pack, rle, synthetic_cases

NARROW = 1 << 16
WIDE = 1 << 17


def _long_literal(data: bytes) -> bytes:
    """One literal tag with a 3-byte length."""
    return bytes([62 << 2]) + (len(data) - 1).to_bytes(3, "little") + data


def _copy4(length: int, off: int) -> bytes:
    return bytes([0x03 | ((length - 1) << 2)]) + off.to_bytes(4, "little")


def _narrow_cases():
    """(id, body, ulen, expected bytes or None) at out_size 64 KiB."""
    cases = []
    for name in ["html", "fireworks.jpeg", "paper-100k.pdf", "urls.10K", "kppkn.gtb", "alice29.txt"]:
        raw = read_testdata(name)[:NARROW]
        (s,), (u,) = native_block_streams(raw)
        cases.append((f"corpus-{name}", s, u, raw))
    for k, raw in enumerate([b"", b"x" * 1000, b"ab" * 5000, b"q" * 65536, b"abcdefg" * 9362]):
        (s,), (u,) = native_block_streams(raw)
        cases.append((f"rle-{k}", s, u, raw))
    big = bytes((i * 131) & 0xFF for i in range(NARROW))
    cases.append(("literal-65536", _long_literal(big), NARROW, big))
    # One byte after the last tag is a tag to K3, which cannot complete.
    return cases + [
        (cid, body, u, None if cid.startswith("trailing-byte") else exp)
        for cid, body, u, exp in synthetic_cases()
    ]


def _wide_cases():
    """(id, body, ulen, expected bytes or None) at out_size 128 KiB: the two
    envelope rows that need more than 64 KiB of output, and their controls
    just inside the envelope."""
    rng = np.random.default_rng(11)
    big = rng.integers(0, 256, NARROW, dtype=np.uint8).tobytes()
    tail = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    head = _long_literal(big) + lit(tail[:60]) + lit(tail[60:])
    exp_16 = big + tail + (big + tail)[len(big) + len(tail) - 65536 :][:64]
    exp_15 = big + tail + (big + tail)[len(big) + len(tail) - 65535 :][:64]
    big1 = rng.integers(0, 256, NARROW + 1, dtype=np.uint8).tobytes()
    return [
        ("offset-65536", head + _copy4(64, 65536), len(exp_16), None),
        ("offset-65535", head + copy2(64, 65535), len(exp_15), exp_15),
        ("offset-65535-copy4", head + _copy4(64, 65535), len(exp_15), exp_15),
        ("literal-65537", _long_literal(big1), len(big1), None),
        ("wide-rle", lit(b"ab") + copy2(64, 2) * 1800, 2 + 64 * 1800, rle(b"ab", 64 * 1800, 2)),
    ]


# Rows decode_xla decodes and K3 refuses (the envelope), and the cut copy
# trailer, which decode_xla reads past and K3 refuses.
ENVELOPE = {"offset-65536", "literal-65537", "trailing-byte-00", "trailing-byte-01"}
XLA_DIFFERS = ENVELOPE | {"truncated-copy-trailer"}

SHAPES = {"narrow": (NARROW, _narrow_cases()), "wide": (WIDE, _wide_cases())}
ROWS = [(shape, i) for shape, (_, cases) in SHAPES.items() for i in range(len(cases))]
IDS = [SHAPES[shape][1][i][0] for shape, i in ROWS]


@pytest.fixture(scope="module")
def decoded():
    res = {}
    for shape, (out_size, cases) in SHAPES.items():
        comp, clens = pack([c[1] for c in cases])
        ulens = np.array([c[2] for c in cases], np.int32)
        args = (jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(ulens))
        k3 = pallas_decode_r4.decode_blocks_jit(comp.shape[1], out_size, interpret=True)(*args)
        xla = decode_xla.decode_blocks_jit(comp.shape[1], out_size)(*args)
        port = cuda_decode_r4.decode_blocks(
            torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), out_size
        )
        as_np = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
        res[shape] = {"k3": as_np(k3), "xla": as_np(xla), "port": tuple(x.numpy() for x in port)}
    return res


def _row(res, i):
    out, ok, total = res
    return out[i], bool(ok[i]), int(total[i])


@pytest.mark.parametrize("shape,i", ROWS, ids=IDS)
def test_port_matches_k3(decoded, shape, i):
    p_out, p_ok, p_total = _row(decoded[shape]["port"], i)
    k_out, k_ok, k_total = _row(decoded[shape]["k3"], i)
    assert p_ok == k_ok
    if p_ok:
        assert p_total == k_total == SHAPES[shape][1][i][2]
        np.testing.assert_array_equal(p_out, k_out)
    else:
        assert not p_out.any()


@pytest.mark.parametrize(
    "shape,i", [r for r, cid in zip(ROWS, IDS) if cid not in XLA_DIFFERS],
    ids=[cid for cid in IDS if cid not in XLA_DIFFERS],
)
def test_port_matches_xla_inside_the_envelope(decoded, shape, i):
    p_out, p_ok, p_total = _row(decoded[shape]["port"], i)
    x_out, x_ok, x_total = _row(decoded[shape]["xla"], i)
    ulen = SHAPES[shape][1][i][2]
    assert p_ok == x_ok
    if p_ok:
        assert p_total == x_total == ulen
        assert bytes(p_out[:ulen]) == bytes(x_out[:ulen])


@pytest.mark.parametrize("shape,i", ROWS, ids=IDS)
def test_port_expected_bytes(decoded, shape, i):
    out, ok, total = _row(decoded[shape]["port"], i)
    expect = SHAPES[shape][1][i][3]
    assert ok == (expect is not None)
    if ok:
        assert total == len(expect) and bytes(out[:total]) == expect and not out[total:].any()
    else:
        assert not out.any()


@pytest.mark.parametrize("cid", sorted(ENVELOPE))
def test_envelope_rows(decoded, cid):
    """Refused by K3 and the port's K3, decoded by decode_xla."""
    shape, i = ROWS[IDS.index(cid)]
    assert not _row(decoded[shape]["k3"], i)[1]
    assert not _row(decoded[shape]["port"], i)[1]
    assert _row(decoded[shape]["xla"], i)[1]


def test_plain_k1_takes_the_envelope_rows():
    """The same rows through the port's K1 plain version, whose envelope is
    decode_xla's but for the cut copy trailer."""
    for shape, (out_size, cases) in SHAPES.items():
        rows = [c for c in cases if c[0] in ENVELOPE]
        comp, clens = pack([c[1] for c in rows])
        ulens = torch.tensor([c[2] for c in rows], dtype=torch.int32)
        _, ok, _ = decode_torch.decode_blocks(torch.from_numpy(comp), torch.from_numpy(clens), ulens, out_size)
        assert bool(ok.all()), shape


def test_cpu_tensors_take_the_plain_version():
    cases = SHAPES["narrow"][1]
    comp, clens = pack([c[1] for c in cases[:8]])
    args = (torch.from_numpy(comp), torch.from_numpy(clens), torch.tensor([c[2] for c in cases[:8]], dtype=torch.int32))
    before = profiling.counters()
    got = cuda_decode_r4.decode_blocks(*args, NARROW)
    assert profiling.since(before)["k3.launches"] == 0
    assert all(torch.equal(a, b) for a, b in zip(got, decode_torch.decode_blocks_r4(*args, NARROW)))


def test_wrapper_rejects_lengths_outside_the_batch():
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_decode_r4.decode_blocks(comp, torch.tensor([2, 13], dtype=torch.int32), torch.tensor([1, 1], dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        cuda_decode_r4.decode_blocks(comp, torch.tensor([2, 2], dtype=torch.int32), torch.tensor([1, 9], dtype=torch.int32), 8)
