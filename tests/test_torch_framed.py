"""The slice as a whole: frames written by snappy_tpu decode in
snappy_tpu_torch (on the CPU, through the plain block decoder) byte for
byte as snappy_tpu decodes them, and the port writes the same frame bytes.
Exact: the outputs are bytes."""

import zlib

import numpy as np
import pytest

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.parallel import framed as ref_framed
from snappy_tpu_torch.parallel import framed, host

from conftest import read_testdata
from torch_helpers import config_from_reference, native_block_streams


def _mixed(n_blocks_bytes):
    parts = [
        read_testdata("html")[:65536],
        read_testdata("fireworks.jpeg")[:40000],
        b"z" * 30000,
        read_testdata("urls.10K")[:50000],
    ]
    return b"".join(parts)[:n_blocks_bytes]


FRAMES = {
    "mixed-crc": (_mixed(185536), RefFrameConfig()),
    "mixed-nocrc": (_mixed(185536), RefFrameConfig(checksum=False)),
    "small-blocks": (_mixed(40000), RefFrameConfig(block_size=8192)),
    "one-byte": (b"a", RefFrameConfig()),
    "empty": (b"", RefFrameConfig()),
}


@pytest.fixture(scope="module")
def ref_frames():
    return {k: snappy_tpu.compress_framed(raw, config=cfg) for k, (raw, cfg) in FRAMES.items()}


@pytest.mark.parametrize("key", list(FRAMES))
def test_reference_frames_decode_identically(ref_frames, key):
    raw, _ = FRAMES[key]
    frame = ref_frames[key]
    got = snappy_tpu_torch.uncompress_framed(frame, device="cpu")
    assert got == snappy_tpu.uncompress_framed(frame) == raw


@pytest.mark.parametrize("key", list(FRAMES))
def test_index_and_reframing_identical(ref_frames, key):
    frame = ref_frames[key]
    a, b = framed.parse_index(frame), ref_framed.parse_index(frame)
    for field in ("flags", "block_size", "total_len", "payload_start"):
        assert getattr(a, field) == getattr(b, field)
    assert np.array_equal(a.comp_lens, b.comp_lens)
    assert (a.crcs is None) == (b.crcs is None)
    if a.crcs is not None:
        assert np.array_equal(a.crcs, b.crcs)
    assert a.block_ranges() == b.block_ranges()
    assert [a.block_ulen(i) for i in range(a.n_blocks)] == [b.block_ulen(i) for i in range(b.n_blocks)]
    assert framed.frame_to_raw(frame) == ref_framed.frame_to_raw(frame)


@pytest.mark.parametrize("key", ["mixed-crc", "mixed-nocrc", "small-blocks", "empty"])
def test_build_frame_identical(key):
    raw, ref_cfg = FRAMES[key]
    bs = ref_cfg.block_size
    streams, _ = native_block_streams(raw, bs) if raw else ([], [])
    raws = [raw[i : i + bs] for i in range(0, len(raw), bs)]
    cfg = config_from_reference(ref_cfg)
    ours = framed.build_frame(streams, raws, len(raw), cfg)
    assert ours == ref_framed.build_frame(streams, raws, len(raw), ref_cfg)
    crcs = [zlib.crc32(r) for r in raws] if cfg.checksum else None
    assert framed.build_frame_header([len(s) for s in streams], crcs, len(raw), cfg) == (
        ref_framed.build_frame_header([len(s) for s in streams], crcs, len(raw), ref_cfg)
    )
    assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


def _corrupt_crc(frame: bytes) -> bytes:
    idx = framed.parse_index(frame)
    f = bytearray(frame)
    crc_off = idx.payload_start - 4 * idx.n_blocks
    f[crc_off] ^= 0x01
    return bytes(f)


def _corrupt_block(frame: bytes) -> bytes:
    idx = framed.parse_index(frame)
    f = bytearray(frame)
    s, e = idx.block_ranges()[1]
    f[s : e] = b"\xff" * (e - s)  # COPY_4 tags with wild offsets
    return bytes(f)


@pytest.mark.parametrize("damage", [_corrupt_crc, _corrupt_block], ids=["crc", "block"])
def test_damaged_frame_raises_in_both(ref_frames, damage):
    bad = damage(ref_frames["mixed-crc"])
    with pytest.raises(snappy_tpu.CorruptInputError):
        snappy_tpu.uncompress_framed(bad)
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        snappy_tpu_torch.uncompress_framed(bad, device="cpu")


@pytest.mark.parametrize(
    "mangle",
    [
        lambda f: f[:10],
        lambda f: b"XXXXXXXX" + f[8:],
        lambda f: f[:-1],
    ],
    ids=["short", "magic", "truncated-payload"],
)
def test_malformed_frame_raises(ref_frames, mangle):
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        snappy_tpu_torch.uncompress_framed(mangle(ref_frames["mixed-crc"]), device="cpu")


def test_dispatch_assemble_split(ref_frames):
    ticket = host.dispatch_uncompress(ref_frames["mixed-nocrc"], device="cpu")
    assert host.assemble_uncompress(ticket) == FRAMES["mixed-nocrc"][0]


def test_no_silent_cpu_fallback(ref_frames):
    """Without a card, the default device raises instead of decoding on
    the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py covers the card")
    with pytest.raises((RuntimeError, AssertionError)):
        snappy_tpu_torch.uncompress_framed(ref_frames["mixed-crc"])
