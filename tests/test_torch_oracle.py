"""The port's ``"cpu"`` backend (its own copy of the NumPy oracle) against
snappy_tpu's ``"cpu"`` backend, and the default backend's choice.

Exact: compressed streams and decoded bytes are identical, and the corrupt
fixtures raise CorruptInputError in both packages.
"""

import pytest

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.errors import CorruptInputError as RefCorruptInputError
from snappy_tpu_torch import api
from snappy_tpu_torch.cpu import oracle
from snappy_tpu_torch.native import runtime as nat

from conftest import CORPUS_SMALL, read_testdata


@pytest.mark.parametrize("name", CORPUS_SMALL)
def test_compress_matches_reference(name):
    raw = read_testdata(name)
    comp = snappy_tpu_torch.compress(raw, backend="cpu")
    assert comp == snappy_tpu.compress(raw, backend="cpu")
    assert snappy_tpu_torch.uncompress(comp, backend="cpu") == raw


@pytest.mark.parametrize("name", ["alice29.txt", "lcet10.txt", "geo.protodata", "urls.10K"])
def test_uncompress_native_streams_matches_reference(name):
    raw = read_testdata(name)
    comp = nat.compress(raw)
    assert snappy_tpu_torch.uncompress(comp, backend="cpu") == snappy_tpu.uncompress(comp, backend="cpu") == raw


def test_foreign_fixture():
    got = snappy_tpu_torch.uncompress(read_testdata("alice29.snappy"), backend="cpu")
    assert got == snappy_tpu.uncompress(read_testdata("alice29.snappy"), backend="cpu") == read_testdata("alice29.txt")


@pytest.mark.parametrize("name", ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"])
def test_baddata_raise_in_both(name):
    data = read_testdata(name)
    with pytest.raises(snappy_tpu_torch.CorruptInputError):
        snappy_tpu_torch.uncompress(data, backend="cpu")
    with pytest.raises(RefCorruptInputError):
        snappy_tpu.uncompress(data, backend="cpu")


@pytest.mark.parametrize("data", [b"", b"a", "text input", b"ab" * 3000])
def test_small_inputs(data):
    comp = snappy_tpu_torch.compress(data, backend="cpu")
    assert comp == snappy_tpu.compress(data, backend="cpu")
    raw = data.encode() if isinstance(data, str) else data
    assert snappy_tpu_torch.uncompress(comp, backend="cpu") == raw


def test_default_backend_is_native_where_it_loads(monkeypatch):
    assert nat.available()
    assert api._host_codec(None) is nat
    monkeypatch.setattr(nat, "available", lambda: False)
    assert api._host_codec(None) is oracle
    raw = read_testdata("html")[:5000]
    assert snappy_tpu_torch.compress(raw) == oracle.compress(raw)
    # An explicit "native" falls back the same way, as the reference's does.
    assert api._host_codec("native") is oracle
    assert snappy_tpu_torch.compress(raw, backend="native") == oracle.compress(raw)
