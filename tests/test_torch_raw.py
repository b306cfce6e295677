"""Raw-stream decode in snappy_tpu_torch (on the CPU, through the plain
block decoder) against snappy_tpu: the foreign fixture, native multi-block
streams, streams past the segmenter's envelope, and the corrupt battery.
Exact: the outputs are bytes."""

import numpy as np
import pytest

import snappy_tpu_torch
from snappy_tpu.core import varint as ref_varint
from snappy_tpu.cpu import oracle
from snappy_tpu.ops import host as ref_host
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import decode_torch
from snappy_tpu_torch.ops import host

from conftest import read_testdata


def port_uncompress(stream: bytes) -> bytes:
    return snappy_tpu_torch.uncompress(stream, backend="torch", device="cpu")


def test_alice29_foreign_fixture():
    assert port_uncompress(read_testdata("alice29.snappy")) == read_testdata("alice29.txt")


def _long_literal_wide_offset() -> tuple[bytes, bytes]:
    """A 70 KiB literal and a COPY_4 reaching 69000 bytes back."""
    rng = np.random.RandomState(3)
    big = rng.randint(0, 256, 70_000).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    body += bytes([(63 << 2) | 3]) + (69_000).to_bytes(4, "little")
    expect = big + big[1000:1064]
    return ref_varint.encode32(len(expect)) + body, expect


def _unsegmentable_literal() -> tuple[bytes, bytes]:
    """One 200 KiB literal: past scan_blocks' 128 KiB segment envelope."""
    big = np.random.RandomState(4).randint(0, 256, 200_000).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    return ref_varint.encode32(len(big)) + body, big


def _native_multiblock() -> tuple[bytes, bytes]:
    raw = (read_testdata("lcet10.txt") * 2)[: 5 * 65536 + 777]
    return nat.compress(raw), raw


STREAMS = {
    "native-multiblock": _native_multiblock,
    "long-literal-wide-offset": _long_literal_wide_offset,
    "unsegmentable-literal": _unsegmentable_literal,
    "empty": lambda: (b"\x00", b""),
    "one-byte": lambda: (nat.compress(b"a"), b"a"),
}


@pytest.mark.parametrize("key", list(STREAMS))
def test_decodes_as_reference(key):
    stream, expect = STREAMS[key]()
    assert port_uncompress(stream) == ref_host.uncompress(stream) == expect


def test_segmenter_envelope():
    stream, _ = _long_literal_wide_offset()
    h = len(ref_varint.encode32(64 + 70_000))
    assert nat.scan_blocks(stream[h:], 70_064) is not None
    stream, big = _unsegmentable_literal()
    h = len(ref_varint.encode32(len(big)))
    assert nat.scan_blocks(stream[h:], len(big)) is None


def test_unsegmentable_stream_over_cpu_limit_refused():
    """An unsegmentable stream above the CPU's whole-block limit decodes (in
    windows) to the bytes of snappy_tpu's xla backend."""
    n = decode_torch.RAW_WHOLE_LIMIT + 1000
    body = bytes([62 << 2]) + (n - 1).to_bytes(3, "little") + bytes(n)
    stream = ref_varint.encode32(n) + body
    assert port_uncompress(stream) == ref_host.uncompress(stream) == bytes(n)


@pytest.mark.parametrize("name", ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"])
def test_baddata_fuzz_files_raise(name):
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        port_uncompress(read_testdata(name))


def _header_zero():
    comp = bytearray(oracle.compress(b"A" * 100000))
    comp[0] = comp[1] = comp[2] = comp[3] = 0
    return bytes(comp)


def _header_two_megabytes():
    comp = bytearray(oracle.compress(b"A" * 100000))
    comp[0] = comp[1] = comp[2] = 0xFF
    comp[3] = 0x00
    return bytes(comp)


def _bitflip():
    comp = bytearray(oracle.compress(b"making sure we don't crash with corrupted input"))
    comp[1] = (~comp[1]) & 0xFF
    comp[3] = comp[2]
    return bytes(comp)


CORRUPT = {
    "header-lies-zero": _header_zero,
    "header-lies-2mb": _header_two_megabytes,
    "bitflip": _bitflip,
    "varint-f0": lambda: bytes([0xF0]),
    "varint-too-long": lambda: bytes([0x80, 0x80, 0x80, 0x80, 0x80, 0x0A]),
    "varint-overflow": lambda: bytes([0xFB, 0xFF, 0xFF, 0xFF, 0x7F]),
    "zero-offset-64": lambda: bytes([0x40, 0x12, 0x00, 0x00]),
    "zero-offset-5": lambda: bytes([0x05, 0x12, 0x00, 0x00]),
    "copy-before-start": lambda: bytes([0x10, 0x00, 0x61, 0x09, 0x20, 0x00]),
    "literal-overrun": lambda: bytes([0x30, (39 << 2), 0x61, 0x62]),
    "truncated": lambda: oracle.compress(b"hello world hello world hello world")[:10],
    "header-lies-unsegmentable": lambda: ref_varint.encode32(6_000_000) + _unsegmentable_literal()[0][3:],
}


@pytest.mark.parametrize("key", list(CORRUPT))
def test_corrupt_streams_raise(key):
    stream = CORRUPT[key]()
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        port_uncompress(stream)
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        snappy_tpu_torch.uncompress(stream)  # native backend


@pytest.mark.parametrize("name", ["html", "fireworks.jpeg", "sample-tweet.json"])
def test_api_roundtrip(name):
    raw = read_testdata(name)
    comp = snappy_tpu_torch.compress(raw)
    assert oracle.uncompress(comp) == raw
    assert snappy_tpu_torch.uncompressed_length(comp) == oracle.uncompressed_length(comp)
    assert snappy_tpu_torch.uncompress(comp) == port_uncompress(comp) == raw
    assert len(comp) <= snappy_tpu_torch.max_compressed_length(len(raw))


def test_api_rejects_unknown_backends():
    with pytest.raises(ValueError):
        snappy_tpu_torch.uncompress(b"\x00", backend="xla")
    with pytest.raises(ValueError):
        snappy_tpu_torch.compress(b"", backend="gpu")
    with pytest.raises(ValueError):
        snappy_tpu_torch.compress(b"", backend="xla")
    # The torch backend is ported: an empty input needs no device.
    assert snappy_tpu_torch.compress(b"", backend="torch") == b"\x00"


def test_pack_rows_pads_and_aligns():
    buf = np.arange(40, dtype=np.uint8)
    rows = host.pack_rows(buf, np.array([0, 10, 25]), np.array([10, 15, 15]))
    assert rows.shape == (3, 32)
    assert bytes(rows[1, :15]) == bytes(range(10, 25)) and not rows[1, 15:].any()
