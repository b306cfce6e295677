"""The port's block encoder on the CPU (the plain version, reached through
the kernel's wrapper) against snappy_tpu's Pallas block encoder, K2, run in
interpret mode with ``contest=False``, on the same rows.

Tolerance: exact, since the outputs are bytes: ``olens`` and
``out[:olens]`` must be identical, for ``min_profit`` 2 (the default) and
1. Every row goes through one batch of one shape, because K2 takes seconds
to compile per shape in interpret mode. Each stream must also decode back
to its row through the port's decoder and through the real libsnappy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import CORPUS
from snappy_tpu.native import libsnappy
from snappy_tpu.ops import pallas_encode
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.ops import cuda_decode, cuda_encode, encode_torch, select
from snappy_tpu_torch.ops.encode_torch import BLOCK_MAX_OUT, ENC_PAD
from snappy_tpu_torch.utils import profiling

from conftest import read_testdata

BLOCK = 1 << 16
WIDTH = BLOCK + ENC_PAD


def _rows():
    """(id, row bytes): the first block of each corpus file of the slice,
    the sentinel row, RLE rows, lengths 0-3, a match that runs into the
    zero padding, and random bytes from a seed."""
    rows = [(f"corpus-{name}", read_testdata(name)[:BLOCK]) for name in CORPUS]
    rows += [
        ("ff", b"\xff" * BLOCK),
        ("q", b"q" * BLOCK),
        ("ab", b"ab" * 3000),
        ("len-0", b""),
        ("len-1", b"a"),
        ("len-2", b"ab"),
        ("len-3", b"abc"),
        ("range", bytes(range(256)) * 8),
        ("into-padding", b"xyzw\x00\x00\x00\x00xyzw"),
        ("ff-groups", b"\xff\xff\xff\xff\x01" * 400),
        ("random", np.random.default_rng(11).integers(0, 256, 5000, dtype=np.uint8).tobytes()),
    ]
    return rows


ROWS = _rows()
IDS = [r[0] for r in ROWS]


@pytest.fixture(scope="module", params=[2, 1], ids=["min_profit-2", "min_profit-1"])
def encoded(request):
    min_profit = request.param
    blocks = np.zeros((24, WIDTH), np.uint8)
    blens = np.zeros(24, np.int32)
    for i, (_, r) in enumerate(ROWS):
        blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
        blens[i] = len(r)
    k2 = pallas_encode.encode_blocks_jit(BLOCK, True, min_profit, contest=False)
    k_out, k_olens = (np.asarray(x) for x in k2(jnp.asarray(blocks), jnp.asarray(blens)))
    p_out, p_olens = cuda_encode.encode_blocks(torch.from_numpy(blocks), torch.from_numpy(blens), min_profit)
    return {"k2": (k_out, k_olens), "port": (p_out.numpy(), p_olens.numpy()), "blocks": blocks, "blens": blens}


@pytest.mark.parametrize("i", range(len(ROWS)), ids=IDS)
def test_port_matches_k2(encoded, i):
    k_out, k_olens = encoded["k2"]
    p_out, p_olens = encoded["port"]
    assert p_olens[i] == k_olens[i]
    assert bytes(p_out[i, : p_olens[i]]) == bytes(k_out[i, : k_olens[i]])
    assert not p_out[i, p_olens[i] :].any()


def test_padding_rows_identical(encoded):
    """The rows past the cases (length 0) encode to nothing in both."""
    n = len(ROWS)
    assert (encoded["port"][1][n:] == 0).all() and (encoded["k2"][1][n:] == 0).all()


@pytest.mark.parametrize("i", range(len(ROWS)), ids=IDS)
def test_streams_decode_in_the_port(encoded, i):
    p_out, p_olens = encoded["port"]
    olen, raw = int(p_olens[i]), ROWS[i][1]
    comp = torch.zeros((1, olen + 8), dtype=torch.uint8)
    comp[0, :olen] = torch.from_numpy(p_out[i, :olen])
    out, ok, total = cuda_decode.decode_blocks(
        comp, torch.tensor([olen], dtype=torch.int32), torch.tensor([len(raw)], dtype=torch.int32), max(len(raw), 1)
    )
    assert bool(ok[0]) and int(total[0]) == len(raw)
    assert bytes(out[0, : len(raw)].numpy()) == raw


@pytest.mark.parametrize("i", range(len(ROWS)), ids=IDS)
def test_streams_decode_under_real_libsnappy(encoded, i):
    if not libsnappy.available():
        pytest.skip("libsnappy not installed")
    p_out, p_olens = encoded["port"]
    raw = ROWS[i][1]
    stream = varint.encode32(len(raw)) + p_out[i, : p_olens[i]].tobytes()
    assert libsnappy.uncompress(stream) == raw


def test_cpu_tensors_take_the_plain_version():
    blocks = torch.zeros((2, 64 + ENC_PAD), dtype=torch.uint8)
    blocks[0, :64] = torch.from_numpy(np.frombuffer(b"abcd" * 16, np.uint8).copy())
    blens = torch.tensor([64, 0], dtype=torch.int32)
    before = profiling.counters()
    out, olens = cuda_encode.encode_blocks(blocks, blens, 2)
    ref = encode_torch.encode_blocks(blocks, blens, 2)
    assert profiling.since(before)["k2.launches"] == 0
    assert torch.equal(out, ref[0]) and torch.equal(olens, ref[1])
    assert out.dtype == torch.uint8 and out.shape == (2, BLOCK_MAX_OUT) and olens.dtype == torch.int32
    assert olens.tolist() == [8, 0]  # literal "abcd" (5 bytes), COPY_2 of 60 at distance 4


def test_plain_version_refuses_rows_that_do_not_fit():
    """Called directly (as on the card, where the lengths are not read), the
    plain version treats a row whose blen does not fit the batch as the
    kernel's guard does: olens -1, all zero."""
    blocks = torch.full((3, 16 + ENC_PAD), 7, dtype=torch.uint8)
    out, olens = encode_torch.encode_blocks(blocks, torch.tensor([16, 17, -1], dtype=torch.int32), 2)
    assert olens.tolist()[1:] == [-1, -1] and not out[1:].any()
    assert olens[0] > 0


@pytest.mark.parametrize(
    "bad", ["blocks-dtype", "blens-dtype", "blens-shape", "blen-over-width", "negative-blen", "narrow-rows", "wide-rows", "noncontiguous"]
)
def test_wrapper_rejects_bad_arguments(bad):
    blocks = torch.zeros((2, 16 + ENC_PAD), dtype=torch.uint8)
    blens = torch.tensor([16, 3], dtype=torch.int32)
    if bad == "blocks-dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "blens-dtype":
        blens = blens.to(torch.int64)
    elif bad == "blens-shape":
        blens = blens[:1]
    elif bad == "blen-over-width":
        blens = torch.tensor([17, 3], dtype=torch.int32)
    elif bad == "negative-blen":
        blens = torch.tensor([-1, 3], dtype=torch.int32)
    elif bad == "narrow-rows":
        blocks = torch.zeros((2, ENC_PAD - 1), dtype=torch.uint8)
        blens = torch.zeros(2, dtype=torch.int32)
    elif bad == "wide-rows":
        blocks = torch.zeros((2, BLOCK + ENC_PAD + 1), dtype=torch.uint8)
    else:
        blocks = torch.zeros((16 + ENC_PAD, 2), dtype=torch.uint8).t()
    with pytest.raises((TypeError, ValueError)):
        cuda_encode.encode_blocks(blocks, blens, 2)


def test_block_encoder_by_device():
    """One dispatch point: select checks the device, the wrapper picks the
    kernel or the plain version by the tensor's device."""
    assert select.block_encoder("cuda") is cuda_encode.encode_blocks
    assert select.block_encoder(torch.device("cuda", 0)) is cuda_encode.encode_blocks
    assert select.block_encoder("cpu") is cuda_encode.encode_blocks
    with pytest.raises(ValueError):
        select.block_encoder("meta")
    with pytest.raises(ValueError):
        cuda_encode.encode_blocks(torch.zeros((1, 16), dtype=torch.uint8, device="meta"),
                                  torch.zeros(1, dtype=torch.int32, device="meta"), 2)
