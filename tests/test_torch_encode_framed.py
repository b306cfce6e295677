"""The write path as a whole, on the CPU: the port's ``compress_framed``,
raw ``compress`` and ``raw_to_frame`` against snappy_tpu run the way it runs
on a TPU, with its Pallas block encoder, K2 (interpret mode, ``contest=False``).

On a CPU host snappy_tpu would pick its XLA encoder, a different parse, so
each reference stream here is built with K2 patched in where the TPU would
select it (``parallel/host.py::block_encoder`` for frames,
``encode_xla._best_encoder`` for raw streams). Only the test patches; the
JAX package is unchanged. Routing is the reference's own.

Tolerance: exact, since the outputs are bytes. The inputs share few block
counts, because K2 takes seconds to compile per shape in interpret mode.
"""

import numpy as np
import pytest

import snappy_tpu
import snappy_tpu.parallel.host as ref_host
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.native import libsnappy
from snappy_tpu.ops import encode_xla
from snappy_tpu.ops import route as ref_route
from snappy_tpu.parallel import framed as ref_framed
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import host, route
from snappy_tpu_torch.parallel import framed
from snappy_tpu_torch.parallel import host as fhost

from conftest import read_testdata
from torch_helpers import config_from_reference, reference_k2  # noqa: F401  (fixture)

BLOCK = 1 << 16


def _routing_tail() -> np.ndarray:
    """A 2004-byte block of random bytes with 100 repeated 4-grams: scored
    alone it sits on the routing threshold (0.05, kept on the device), scored
    beside full blocks just under it (routed to the host)."""
    tail = np.random.default_rng(5).integers(0, 256, 2004, dtype=np.uint8)
    for j in range(100):
        tail[1000 + 10 * j : 1004 + 10 * j] = tail[10 * j : 10 * j + 4]
    return tail


INPUTS = {
    # two device blocks, the second a short tail
    "html": read_testdata("html"),
    # a jpeg block between two text blocks: routed to the host
    "mixed": read_testdata("html")[:BLOCK] + read_testdata("fireworks.jpeg")[:BLOCK] + read_testdata("alice29.txt")[:30000],
    # 16 random blocks (routed) and the tail above
    "routing-tail": np.random.default_rng(6).integers(0, 256, 16 * BLOCK, dtype=np.uint8).tobytes()
    + _routing_tail().tobytes(),
}

FRAMES = {
    "html": ("html", RefFrameConfig()),
    "mixed": ("mixed", RefFrameConfig()),
    "mixed-nocrc": ("mixed", RefFrameConfig(checksum=False)),
    "html-min-profit-1": ("html", RefFrameConfig(min_profit=1)),
}


@pytest.fixture(scope="module")
def port_frames():
    return {
        k: snappy_tpu_torch.compress_framed(INPUTS[name], config_from_reference(cfg), device="cpu")
        for k, (name, cfg) in FRAMES.items()
    }


@pytest.mark.parametrize("key", list(FRAMES))
def test_frame_identical_to_reference(reference_k2, port_frames, key):
    name, cfg = FRAMES[key]
    assert port_frames[key] == snappy_tpu.compress_framed(INPUTS[name], config=cfg)


@pytest.mark.parametrize("key", list(FRAMES))
def test_frames_cross_between_packages(port_frames, key):
    raw = INPUTS[FRAMES[key][0]]
    frame = port_frames[key]
    assert snappy_tpu.uncompress_framed(frame) == raw
    assert snappy_tpu_torch.uncompress_framed(frame, device="cpu") == raw
    ref = snappy_tpu.compress_framed(raw, config=FRAMES[key][1])
    assert snappy_tpu_torch.uncompress_framed(ref, device="cpu") == raw


@pytest.mark.parametrize("key", list(FRAMES))
def test_frame_decodes_under_real_libsnappy(port_frames, key):
    if not libsnappy.available():
        pytest.skip("libsnappy not installed")
    raw = INPUTS[FRAMES[key][0]]
    assert libsnappy.uncompress(framed.frame_to_raw(port_frames[key])) == raw


def test_routed_blocks_are_the_native_encoders(port_frames):
    """The jpeg block of "mixed" goes to the host: its stream is the native
    encoder's."""
    raw = INPUTS["mixed"]
    idx = framed.parse_index(port_frames["mixed"])
    s, e = idx.block_ranges()[1]
    buf, blens = host.blockify(np.frombuffer(raw, np.uint8), BLOCK)
    assert route.host_blocks(buf, blens).tolist() == [1]
    assert port_frames["mixed"][s:e] == nat.compress_rows(buf, blens, [1])[0]


def test_dup_ratios_identical_with_ragged_tail():
    raw = np.frombuffer(INPUTS["mixed"] + INPUTS["routing-tail"][: 3 * BLOCK] + b"z" * 700, np.uint8)
    for bs in (BLOCK, 8192, 1000):
        buf, blens = host.blockify(raw, bs)
        n = len(blens)
        ref_buf, ref_blens = ref_host._blockify(raw, bs, n)
        np.testing.assert_array_equal(buf, ref_buf)
        np.testing.assert_array_equal(blens, ref_blens)
        for k in (n, n - 1, 1):
            got = route.dup_ratios(buf[:k], blens[:k], k)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref_route.dup_ratios(buf, blens, k))
    assert route.DUP_THRESHOLD == ref_route.DUP_THRESHOLD


def test_routing_depends_on_the_batch():
    """The tail block routes to the host when scored beside full blocks, and
    stays on the device when scored alone, in both packages."""
    buf, blens = host.blockify(np.frombuffer(INPUTS["routing-tail"], np.uint8), BLOCK)
    assert route.host_blocks(buf, blens).tolist() == list(range(17))
    assert route.host_blocks(buf[16:], blens[16:]).tolist() == []
    assert ref_route.dup_ratios(buf, blens, 17)[16] < ref_route.DUP_THRESHOLD <= ref_route.dup_ratios(buf[16:], blens[16:], 1)[0]


@pytest.mark.parametrize("name", ["html", "mixed", "routing-tail"])
def test_raw_stream_identical_to_reference(reference_k2, name):
    """The raw path routes 16 blocks at a time, as the reference does, so
    the routing tail stays on the device there."""
    raw = INPUTS[name]
    ours = snappy_tpu_torch.compress(raw, backend="torch", device="cpu")
    assert ours == encode_xla.compress_host(np.frombuffer(raw, np.uint8))
    assert nat.uncompress(ours) == raw
    if libsnappy.available():
        assert libsnappy.uncompress(ours) == raw


def test_raw_compress_empty_and_api():
    assert snappy_tpu_torch.compress(b"", backend="torch", device="cpu") == b"\x00"
    assert snappy_tpu_torch.compress("héllo", backend="torch", device="cpu") == snappy_tpu_torch.compress(
        "héllo".encode(), backend="torch", device="cpu"
    )
    with pytest.raises(ValueError):
        snappy_tpu_torch.compress(b"abc", backend="xla")


def _one_literal(raw: bytes) -> bytes:
    """A raw stream of ``raw`` as one literal (at most 16 MiB)."""
    return bytes(varint.encode32(len(raw))) + bytes([62 << 2]) + (len(raw) - 1).to_bytes(3, "little") + raw


@pytest.mark.parametrize("source", ["native", "one-literal"])
def test_raw_to_frame_identical_to_reference(reference_k2, source):
    """A native raw stream reframes without re-encoding; one literal longer
    than the segmenter's 128 KiB cannot be cut into blocks and is
    compressed again."""
    raw = read_testdata("html")[:BLOCK] + read_testdata("fireworks.jpeg")[:70000]
    stream = nat.compress(raw) if source == "native" else _one_literal(raw)
    assert (nat.scan_blocks(stream[3:], len(raw)) is None) == (source == "one-literal")
    for cfg in (RefFrameConfig(), RefFrameConfig(checksum=False)):
        ours = framed.raw_to_frame(stream, config_from_reference(cfg), device="cpu")
        assert ours == ref_framed.raw_to_frame(stream, cfg)
        assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


def test_raw_to_frame_segment_longer_than_a_block():
    """A stream the segmenter cuts into one 100 KiB segment: the reference
    reuses it as one block and writes a frame its own reader refuses (block
    count mismatch); the port compresses such a stream again."""
    raw = read_testdata("html")
    stream = _one_literal(raw)
    assert nat.scan_blocks(stream[3:], len(raw))[1].tolist() == [len(raw)]
    with pytest.raises(snappy_tpu.CorruptInputError):
        snappy_tpu.uncompress_framed(ref_framed.raw_to_frame(stream))
    ours = framed.raw_to_frame(stream, device="cpu")
    assert ours == snappy_tpu_torch.compress_framed(raw, device="cpu")
    assert snappy_tpu.uncompress_framed(ours) == raw


def test_empty_and_tiny_frames(reference_k2):
    for raw in (b"", b"a", b"abcdefgh" * 100):
        frame = snappy_tpu_torch.compress_framed(raw, device="cpu")
        assert frame == snappy_tpu.compress_framed(raw)
        assert snappy_tpu_torch.uncompress_framed(frame, device="cpu") == raw


@pytest.mark.parametrize("name", ["html", "sample-tweet.json"])
def test_density_no_worse_than_native(name):
    raw = read_testdata(name)
    frame = snappy_tpu_torch.compress_framed(raw, device="cpu")
    ours = int(framed.parse_index(frame).comp_lens.sum())
    buf, blens = host.blockify(np.frombuffer(raw, np.uint8), BLOCK)
    native = sum(len(s) for s in nat.compress_rows(buf, blens, np.arange(len(blens))))
    assert ours <= native


def test_dispatch_assemble_split():
    ticket = fhost.dispatch_compress(INPUTS["mixed"], device="cpu")
    assert snappy_tpu_torch.uncompress_framed(fhost.assemble_compress(ticket), device="cpu") == INPUTS["mixed"]


def test_bad_block_size_refused():
    with pytest.raises(ValueError):
        snappy_tpu_torch.compress_framed(b"abc", snappy_tpu_torch.FrameConfig(block_size=0), device="cpu")
    with pytest.raises(ValueError):
        snappy_tpu_torch.compress_framed(b"abc", snappy_tpu_torch.FrameConfig(block_size=1 << 17), device="cpu")


def test_no_silent_cpu_fallback():
    """Without a card, the default device raises instead of encoding on the
    CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers the card")
    with pytest.raises((RuntimeError, AssertionError)):
        snappy_tpu_torch.compress_framed(INPUTS["html"])
    with pytest.raises((RuntimeError, AssertionError)):
        snappy_tpu_torch.compress(INPUTS["html"], backend="torch")


ONE_BYTE_BLOCKS = read_testdata("html")[:48]


def test_reference_refuses_one_byte_blocks():
    """A reference behaviour, not a port fault: on a host without a TPU
    snappy_tpu's encoder (``encode_xla``) cannot take a one-byte block."""
    with pytest.raises(ValueError):
        snappy_tpu.compress_framed(ONE_BYTE_BLOCKS, RefFrameConfig(block_size=1))


@pytest.mark.parametrize("encoder", ["kernel", "array"])
def test_one_byte_blocks_frame_in_the_port(encoder):
    """The port frames one-byte blocks with either encoder, and the
    reference decodes the frame."""
    cfg = snappy_tpu_torch.FrameConfig(block_size=1)
    frame = snappy_tpu_torch.compress_framed(ONE_BYTE_BLOCKS, cfg, device="cpu", encoder=encoder)
    assert framed.parse_index(frame).n_blocks == len(ONE_BYTE_BLOCKS)
    assert snappy_tpu.uncompress_framed(frame) == ONE_BYTE_BLOCKS
    assert snappy_tpu_torch.uncompress_framed(frame, device="cpu") == ONE_BYTE_BLOCKS
