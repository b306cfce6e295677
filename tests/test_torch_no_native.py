"""The port where the native C++ library cannot load, against the reference
in the same state.

Both packages' ``native.runtime._load`` are patched to raise, as on a host
where g++ cannot build ``snappy_native.cpp``. The reference then routes no
block to the host encoder, decodes raw streams without the segmenter,
parses the varint header itself and reframes a raw stream by decoding and
compressing it again; the port must give the same bytes. As in
``tests/test_torch_encode_framed.py``, the reference runs with K2 (interpret
mode, ``contest=False``) patched in where a TPU would select it, and only
the test patches. The port runs its plain versions on the CPU.

Tolerance: exact, since the outputs are bytes.
"""

import numpy as np
import pytest

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.native import runtime as ref_nat
from snappy_tpu.ops import encode_xla
from snappy_tpu.parallel import framed as ref_framed
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import host, route
from snappy_tpu_torch.parallel import framed

from conftest import read_testdata
from torch_helpers import config_from_reference, patch_reference_k2

BLOCK = 1 << 16


def _unloadable():
    raise OSError("native library cannot load here")


@pytest.fixture
def no_native(monkeypatch):
    """Neither package can load its native library; the reference runs K2
    where a TPU would."""
    monkeypatch.setattr(nat, "_load", _unloadable)
    monkeypatch.setattr(ref_nat, "_load", _unloadable)
    patch_reference_k2(monkeypatch)
    assert not nat.available() and not ref_nat.available()


def test_fireworks_routes_to_the_host_only_with_the_library(monkeypatch):
    """The jpeg's blocks go to the native encoder where it loads, and stay
    on the device where it does not: the cases below take the second path."""
    buf, blens = host.blockify(np.frombuffer(read_testdata("fireworks.jpeg"), np.uint8), BLOCK)
    assert route.host_blocks(buf, blens).tolist() == [0, 1]
    monkeypatch.setattr(nat, "_load", _unloadable)
    assert route.host_blocks(buf, blens).tolist() == []


@pytest.mark.parametrize("checksum", [True, False])
def test_compress_framed(no_native, checksum):
    raw = read_testdata("fireworks.jpeg")
    cfg = RefFrameConfig(checksum=checksum)
    ours = snappy_tpu_torch.compress_framed(raw, config_from_reference(cfg), device="cpu")
    assert ours == snappy_tpu.compress_framed(raw, config=cfg)
    assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


def test_raw_compress(no_native):
    raw = read_testdata("fireworks.jpeg")
    ours = snappy_tpu_torch.compress(raw, backend="torch", device="cpu")
    assert ours == encode_xla.compress_host(np.frombuffer(raw, np.uint8))
    assert snappy_tpu_torch.uncompress(ours, backend="cpu") == raw


@pytest.mark.parametrize("backend", ["torch", None])
def test_uncompress_alice(no_native, backend):
    """The torch backend decodes the stream as one block; the default
    backend falls back to the oracle."""
    comp = read_testdata("alice29.snappy")
    ours = snappy_tpu_torch.uncompress(comp, backend=backend, device="cpu")
    assert ours == snappy_tpu.uncompress(comp) == read_testdata("alice29.txt")


def test_uncompress_corrupt_and_empty(no_native):
    assert snappy_tpu_torch.uncompress(b"\x00", backend="torch", device="cpu") == b""
    for bad in ("baddata1.snappy", "baddata2.snappy", "baddata3.snappy"):
        with pytest.raises(snappy_tpu_torch.CorruptInputError):
            snappy_tpu_torch.uncompress(read_testdata(bad), backend="torch", device="cpu")


@pytest.mark.parametrize("name", ["alice29.snappy", "baddata1.snappy"])
def test_uncompressed_length(no_native, name):
    comp = read_testdata(name)
    assert snappy_tpu_torch.uncompressed_length(comp) == snappy_tpu.uncompressed_length(comp)


def test_uncompressed_length_refuses_a_bad_varint(no_native):
    for bad in (b"", b"\x80", b"\xff\xff\xff\xff\x10"):
        with pytest.raises(snappy_tpu_torch.CorruptInputError):
            snappy_tpu_torch.uncompressed_length(bad)


@pytest.mark.parametrize("checksum", [True, False])
def test_raw_to_frame(no_native, checksum):
    """A raw stream of two 64 KiB blocks, written while the oracle is the
    only encoder: without the segmenter both packages decode it and
    compress it again."""
    raw = read_testdata("html")[:BLOCK] + read_testdata("fireworks.jpeg")[:70000]
    stream = snappy_tpu_torch.compress(raw, backend="cpu")
    cfg = RefFrameConfig(checksum=checksum)
    ours = framed.raw_to_frame(stream, config_from_reference(cfg), device="cpu")
    assert ours == ref_framed.raw_to_frame(stream, cfg)
    assert snappy_tpu_torch.uncompress_framed(ours, device="cpu") == raw


@pytest.mark.parametrize("name", ["html", "fireworks.jpeg"])
def test_native_backend_falls_back_to_the_oracle(no_native, name):
    """backend="native" takes the oracle where the library cannot load, as
    the reference's does, in both directions."""
    raw = read_testdata(name)
    ours = snappy_tpu_torch.compress(raw, backend="native")
    assert ours == snappy_tpu.compress(raw, backend="native") == snappy_tpu_torch.compress(raw, backend="cpu")
    assert snappy_tpu_torch.uncompress(ours, backend="native") == snappy_tpu.uncompress(ours, backend="native") == raw


@pytest.mark.parametrize("loads", [True, False])
@pytest.mark.parametrize("backend", ["bogus", "xla"])
def test_unknown_backend_raises(monkeypatch, loads, backend):
    """An unknown name raises, with or without the native library, where the
    reference would run its oracle (or, for "xla", its JAX path): a typo
    must not silently take the slowest codec."""
    if not loads:
        monkeypatch.setattr(nat, "_load", _unloadable)
    assert nat.available() == loads
    stream = snappy_tpu_torch.compress(b"hello hello hello", backend="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        snappy_tpu_torch.compress(b"hello hello hello", backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        snappy_tpu_torch.uncompress(stream, backend=backend)
