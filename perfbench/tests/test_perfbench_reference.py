"""The plain reference decoder, the frozen encoder and the controls."""

from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import encoder, reference
from perfbench.data import corpus

TESTDATA = Path(__file__).resolve().parents[2] / "testdata"


def test_decodes_the_corpus_streams_and_refuses_the_bad_ones():
    good = sorted(TESTDATA.glob("*.snappy"))
    good = [p for p in good if not p.name.startswith("baddata")]
    assert good
    for path in good:
        raw = (TESTDATA / path.stem).with_suffix(".txt") if not (TESTDATA / path.stem).exists() else TESTDATA / path.stem
        assert reference.decode_raw(path.read_bytes()) == raw.read_bytes()
    bad = sorted(TESTDATA.glob("baddata*.snappy"))
    assert len(bad) == 3
    for path in bad:
        assert reference.decode_raw(path.read_bytes()) is None, path.name


def rows(streams):
    width = max(len(s) for s in streams) + 8
    comp = torch.zeros((len(streams), width), dtype=torch.uint8)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = torch.tensor(list(s), dtype=torch.uint8)
    return comp, torch.tensor([len(s) for s in streams])


def test_hand_made_streams():
    cases = [  # (stream, expected bytes or None)
        (b"\x08abc", b"abc"),
        (b"\x00a\x15\x01", b"a" * 10),  # a copy of 9 at offset 1 reads its own output
        (b"\x04ab\x16\x02\x00", b"ab" * 4),  # a 2-byte-offset copy of 6 at offset 2
        (b"\xf0\x0b" + b"x" * 12, b"x" * 12),  # a literal whose length takes one more byte
        (b"\xf4\x0b\x00" + b"y" * 12, b"y" * 12),  # ... and two
        (b"\x00a\x01\x00", None),  # offset 0
        (b"\x00a\x01\x02", None),  # offset past the row's start
        (b"\x0cab", None),  # a literal that runs past the stream
        (b"\x00a\x16", None),  # a copy tag cut short
        (b"", b""),
    ]
    comp, clens = rows([s for s, _ in cases])
    expect = torch.tensor([len(e) if e is not None else 10 for _, e in cases])
    out, ok = reference.decode_rows(comp, clens, expect, 16)
    for i, (_, e) in enumerate(cases):
        assert bool(ok[i]) == (e is not None), i
        if e is not None:
            assert bytes(out[i, : len(e)].tolist()) == e and not out[i, len(e):].any()
    # A length that differs from the stream's is refused.
    out, ok = reference.decode_rows(comp[:1], clens[:1], torch.tensor([4]), 16)
    assert not bool(ok[0])


@pytest.mark.parametrize("block", [65536, 32768, 4096])
def test_frozen_encoder_streams_decode_and_the_controls_fail(block):
    files = ["alice29.txt", "html", "fireworks.jpeg", "kppkn.gtb", "sample-tweet.json"]
    data = np.concatenate([np.frombuffer((corpus.CORPUS / f).read_bytes(), np.uint8) for f in files])
    n = len(data) // block
    blocks = data[: n * block].reshape(n, block)
    lens = np.full(n, block, np.int32)
    width = encoder.max_compressed_length(block) + 16
    comp, clens = encoder.compress_rows(blocks, lens, width)
    assert (clens <= encoder.max_compressed_length(block)).all()
    out, ok = reference.decode_rows(torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(lens), block)
    assert bool(ok.all()) and torch.equal(out, torch.from_numpy(blocks))
    # The control decoder moves each copy as one block: rows with a copy
    # that reads its own output come out wrong, and none is refused.
    out, ok = reference.decode_rows(torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(lens), block,
                                    overlap=False)
    assert bool(ok.all()) and (out != torch.from_numpy(blocks)).any(dim=1).sum() > 0
    # The control encoder trusts its hash table: its streams decode to
    # other bytes.
    comp, clens = encoder.compress_rows(blocks, lens, width, control=True)
    out, ok = reference.decode_rows(torch.from_numpy(comp), torch.from_numpy(clens), torch.from_numpy(lens), block)
    assert (~ok | (out != torch.from_numpy(blocks)).any(dim=1)).sum() > n // 2


def test_frozen_encoder_is_the_programs_source_when_taken():
    source = encoder.SOURCE.read_bytes()
    assert source.count(encoder.VERIFY_LINE) == 1 and b"snappy_tpu_compress_rows" in source
