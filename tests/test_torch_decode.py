"""The port's block decoder on the CPU (the plain version, reached through
the kernel's wrapper) against snappy_tpu's two block decoders on the same
inputs: K1, the Pallas kernel in interpret mode, and decode_xla.

Tolerance: exact, since the outputs are bytes. ``ok`` must be identical,
and ``out[:ulen]`` and ``total`` identical where ``ok``. Every case goes
through one batch of one shape, because K1 takes many seconds to compile
per shape in interpret mode.

Two known differences between the reference decoders are pinned on their
own: a trailing byte after the last tag (the port and decode_xla ignore
it, K1 rejects the block), and a copy whose offset bytes are cut off by
the end of the stream (the port and K1 reject it, decode_xla reads the
zero padding as offset bytes and accepts it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from snappy_tpu.ops import decode_xla, pallas_decode
from snappy_tpu_torch.ops import cuda_decode, decode_torch, select
from snappy_tpu_torch.utils import profiling

from conftest import read_testdata
from torch_helpers import native_block_streams, pack, synthetic_cases

OUT_SIZE = 1 << 16


def _cases():
    """(id, body, ulen, expected bytes or None for corrupt)."""
    cases = []
    for name in ["html", "fireworks.jpeg", "paper-100k.pdf", "urls.10K", "kppkn.gtb"]:
        raw = read_testdata(name)[: 2 * OUT_SIZE]
        streams, ulens = native_block_streams(raw)
        for i, (s, u) in enumerate(zip(streams, ulens)):
            cases.append((f"corpus-{name}-{i}", s, u, raw[i * OUT_SIZE : i * OUT_SIZE + u]))
    simple = [
        b"",
        b"a",
        b"hello hello hello hello world world",
        b"x" * 1000,
        b"ab" * 5000,
        b"q" * 65536,
        bytes(range(256)) * 16,
        b"abcdefg" * 9363,
    ]
    for k, raw in enumerate(simple):
        streams, ulens = native_block_streams(raw)
        for i, (s, u) in enumerate(zip(streams, ulens)):
            cases.append((f"simple-{k}-{i}", s, u, raw[i * OUT_SIZE : i * OUT_SIZE + u]))
    return cases + synthetic_cases()


CASES = _cases()
IDS = [c[0] for c in CASES]
# Cases where one reference decoder departs from the port (pinned below).
K1_DIFFERS = {"trailing-byte-00", "trailing-byte-01"}
XLA_DIFFERS = {"truncated-copy-trailer"}


@pytest.fixture(scope="module")
def decoded():
    comp, clens = pack([c[1] for c in CASES])
    ulens = np.array([c[2] for c in CASES], np.int32)
    args = (jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(ulens))
    k1 = pallas_decode.decode_blocks_jit(comp.shape[1], OUT_SIZE, interpret=True)(*args)
    xla = decode_xla.decode_blocks_jit(comp.shape[1], OUT_SIZE)(*args)
    port = cuda_decode.decode_blocks(
        torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(ulens), OUT_SIZE
    )
    as_np = lambda r: tuple(np.asarray(x) for x in r)  # noqa: E731
    return {"k1": as_np(k1), "xla": as_np(xla), "port": tuple(x.numpy() for x in port)}


def _row(res, i):
    out, ok, total = res
    return out[i], bool(ok[i]), int(total[i])


def _assert_same(port, ref, ulen):
    p_out, p_ok, p_total = port
    r_out, r_ok, r_total = ref
    assert p_ok == r_ok
    if p_ok:
        assert p_total == r_total == ulen
        assert bytes(p_out[:ulen]) == bytes(r_out[:ulen])


def _agreeing(differs):
    keep = [i for i in range(len(CASES)) if IDS[i] not in differs]
    return pytest.mark.parametrize("i", keep, ids=[IDS[i] for i in keep])


@_agreeing(XLA_DIFFERS)
def test_port_matches_xla(decoded, i):
    _assert_same(_row(decoded["port"], i), _row(decoded["xla"], i), CASES[i][2])


@_agreeing(K1_DIFFERS)
def test_port_matches_k1(decoded, i):
    _assert_same(_row(decoded["port"], i), _row(decoded["k1"], i), CASES[i][2])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_port_expected_bytes(decoded, i):
    """The decoded bytes themselves, and the port's zero fill: zero past
    total in a row that decodes, all zero in a row that does not."""
    out, ok, total = _row(decoded["port"], i)
    expect = CASES[i][3]
    assert ok == (expect is not None)
    if ok:
        assert total == len(expect)
        assert bytes(out[:total]) == expect
        assert not out[total:].any()
    else:
        assert not out.any()


def test_trailing_byte(decoded):
    """One byte after the last tag: ignored by the port and decode_xla (and
    the native decoder), rejected by K1."""
    for cid in sorted(K1_DIFFERS):
        i = IDS.index(cid)
        assert _row(decoded["port"], i)[1] and _row(decoded["xla"], i)[1]
        assert not _row(decoded["k1"], i)[1]
        _assert_same(_row(decoded["port"], i), _row(decoded["xla"], i), CASES[i][2])


def test_truncated_copy_trailer(decoded):
    """A COPY_2 whose last offset byte is cut off: rejected by the port and
    K1; decode_xla reads the zero padding and accepts it."""
    i = IDS.index("truncated-copy-trailer")
    assert not _row(decoded["port"], i)[1] and not _row(decoded["k1"], i)[1]
    assert _row(decoded["xla"], i)[1]


def test_cpu_tensors_take_the_plain_version():
    comp, clens = pack([CASES[IDS.index("copy4")][1]])
    args = (torch.from_numpy(comp), torch.from_numpy(clens), torch.tensor([8], dtype=torch.int32))
    before = profiling.counters()
    out, ok, total = cuda_decode.decode_blocks(*args, 16)
    ref = decode_torch.decode_blocks(*args, 16)
    assert profiling.since(before)["k1.launches"] == 0
    assert all(torch.equal(a, b) for a, b in zip((out, ok, total), ref))
    assert out.dtype == torch.uint8 and ok.dtype == torch.bool and total.dtype == torch.int32


@pytest.mark.parametrize(
    "bad",
    ["comp-dtype", "clens-dtype", "ulens-shape", "ulen-over-out-size", "clen-over-width", "narrow-rows", "noncontiguous"],
)
def test_wrapper_rejects_bad_arguments(bad):
    comp = torch.zeros((2, 16), dtype=torch.uint8)
    clens = torch.tensor([2, 2], dtype=torch.int32)
    ulens = torch.tensor([1, 1], dtype=torch.int32)
    out_size = 8
    if bad == "comp-dtype":
        comp = comp.to(torch.int32)
    elif bad == "clens-dtype":
        clens = clens.to(torch.int64)
    elif bad == "ulens-shape":
        ulens = ulens[:1]
    elif bad == "ulen-over-out-size":
        ulens = torch.tensor([1, 9], dtype=torch.int32)
    elif bad == "clen-over-width":
        clens = torch.tensor([2, 13], dtype=torch.int32)
    elif bad == "narrow-rows":
        comp = torch.zeros((2, 4), dtype=torch.uint8)
        clens = torch.zeros(2, dtype=torch.int32)
    else:
        comp = torch.zeros((16, 2), dtype=torch.uint8).t()
    with pytest.raises((TypeError, ValueError)):
        cuda_decode.decode_blocks(comp, clens, ulens, out_size)


def test_block_decoder_by_device():
    """One dispatch point: select checks the device, the wrapper picks the
    kernel or the plain version by the tensor's device."""
    assert select.block_decoder("cuda") is cuda_decode.decode_blocks
    assert select.block_decoder(torch.device("cuda", 0)) is cuda_decode.decode_blocks
    assert select.block_decoder("cpu") is cuda_decode.decode_blocks
    with pytest.raises(ValueError):
        select.block_decoder("meta")
