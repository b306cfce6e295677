"""The port's windowed raw decoder (``decode_torch.decode_raw_windowed``)
against snappy_tpu's (``decode_xla.decode_raw_windowed``) on the same
streams, and the raw API on a stream above the CPU's whole-block limit.

Exact: the outputs are bytes, and a corrupt stream raises CorruptInputError
in both packages. The streams that need many windows run with small
windows in both packages (as ``tests/test_decode_xla.py`` does), the
others with the production windows.
"""

import numpy as np
import pytest

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core import varint
from snappy_tpu.core.errors import CorruptInputError as RefCorruptInputError
from snappy_tpu.cpu import oracle
from snappy_tpu.ops import decode_xla
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import decode_torch

from conftest import read_testdata


def _copy4(length: int, off: int) -> bytes:
    return bytes([0x03 | ((length - 1) << 2)]) + off.to_bytes(4, "little")


def _long_literal(data: bytes) -> bytes:
    return bytes([63 << 2]) + (len(data) - 1).to_bytes(4, "little") + data


def _far_copies(lit: bytes, total: int, off: int = 150_000) -> tuple[bytes, bytes]:
    """A literal, then COPY_4s of 64 bytes at ``off`` up to ``total`` bytes
    of output (the shape ``scan_blocks`` declines), and its bytes."""
    n = (total - len(lit)) // 64
    stream = varint.encode32(len(lit) + 64 * n) + _long_literal(lit) + _copy4(64, off) * n
    exp = np.empty(len(lit) + 64 * n, np.uint8)
    exp[: len(lit)] = np.frombuffer(lit, np.uint8)
    for o in range(len(lit), len(exp), 64):
        exp[o : o + 64] = exp[o - off : o - off + 64]
    return stream, exp.tobytes()


def _both(stream: bytes) -> tuple[bytes, bytes]:
    comp = np.frombuffer(stream, np.uint8)
    ulen, hdr = varint.parse32(comp, 0)
    return (
        decode_torch.decode_raw_windowed(comp, ulen, hdr),
        decode_xla.decode_raw_windowed(comp, ulen, hdr),
    )


def test_hostile_stream():
    """The stream of bench.py's windowed stage: the corpus mix's first
    200,000 bytes as one literal, then far COPY_4s up to 2 MiB."""
    lit = (read_testdata("alice29.txt") + read_testdata("html"))[:200_000]
    stream, exp = _far_copies(lit, 2 << 20)
    assert nat.scan_blocks(stream[len(varint.encode32(len(exp))) :], len(exp)) is None
    port, ref = _both(stream)
    assert port == ref == exp


def test_stream_above_the_whole_block_limit():
    """A literal longer than a window (copied on the host), then COPY_4s: one
    window pass. Through the windowed decoders and through both raw APIs on
    the CPU."""
    lit = np.random.default_rng(2).integers(0, 256, decode_torch.RAW_WHOLE_LIMIT + 100_000, dtype=np.uint8)
    stream, exp = _far_copies(lit.tobytes(), len(lit) + 64 * 2000)
    assert len(stream) > decode_torch.RAW_WHOLE_LIMIT == decode_xla.RAW_WHOLE_LIMIT
    port, ref = _both(stream)
    assert port == ref == exp
    assert snappy_tpu_torch.uncompress(stream, backend="torch", device="cpu") == exp
    assert snappy_tpu.uncompress(stream, backend="xla") == exp


@pytest.fixture
def small_windows(monkeypatch):
    """Windows of 16 KiB of input in both packages, so that small streams
    cross many of them."""
    for mod in (decode_torch, decode_xla):
        monkeypatch.setattr(mod, "WINDOW_C", 1 << 14)
        monkeypatch.setattr(mod, "WINDOW_U", (1 << 14) + (1 << 17))
    decode_xla._window_pass_jit.cache_clear()
    yield
    decode_xla._window_pass_jit.cache_clear()


def _giant_literal():
    big = np.random.RandomState(5).randint(0, 256, 100_000).astype(np.uint8).tobytes()
    return varint.encode32(len(big)) + bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big, big


def _cross_window_copy():
    stream, big = _giant_literal()
    exp = big + big[10_000:10_064]
    return varint.encode32(len(exp)) + stream[3:] + _copy4(64, 90_000), exp


STREAMS = {
    "native-alice29": lambda: (nat.compress(read_testdata("alice29.txt")), read_testdata("alice29.txt")),
    "foreign-alice29": lambda: (read_testdata("alice29.snappy"), read_testdata("alice29.txt")),
    "giant-literal": _giant_literal,
    "cross-window-copy": _cross_window_copy,
    "rle-chain": lambda: (nat.compress(b"a" * 200_000 + bytes(range(256)) * 64), b"a" * 200_000 + bytes(range(256)) * 64),
}


@pytest.mark.parametrize("key", list(STREAMS))
def test_many_windows(small_windows, key):
    stream, exp = STREAMS[key]()
    port, ref = _both(stream)
    assert port == ref == exp


def _corrupt():
    html = oracle.compress(read_testdata("html"))
    giant, big = _giant_literal()
    return {
        "truncated": html[: len(html) // 2],
        "giant-literal-overrun": giant[:-10],
        "header-short": varint.encode32(len(big) - 1) + giant[3:],
        "header-long": varint.encode32(len(big) + 1) + giant[3:],
        "offset-before-start": giant + _copy4(64, 200_000),
        "offset-zero": giant + _copy4(64, 0),
        "copy-first": varint.encode32(64) + _copy4(64, 1) + b"\x00" * 20_000,
    }


@pytest.mark.parametrize("key", list(_corrupt()))
def test_corrupt_streams_raise_in_both(small_windows, key):
    stream = _corrupt()[key]
    comp = np.frombuffer(stream, np.uint8)
    ulen, hdr = varint.parse32(comp, 0)
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        decode_torch.decode_raw_windowed(comp, ulen, hdr)
    with pytest.raises(RefCorruptInputError):
        decode_xla.decode_raw_windowed(comp, ulen, hdr)
