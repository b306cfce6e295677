"""The data generators: deterministic for a seed, in their configuration's
shapes, and the lineitem rows read back field by field."""

import struct

import numpy as np
import pytest
import torch

from perfbench.data import corpus, lineitem
from perfbench.registry import Registry

REG = Registry()
CPU = torch.device("cpu")
SEED = 2**31 + 77


def small(name, **sizes):
    config = REG.config(name)
    config.update(sizes)
    return config


@pytest.mark.parametrize("name, block", [("corpus_64k", 4096), ("shuffle_32k", 2048)])
def test_generators_are_deterministic_and_shaped(name, block):
    config = small(name, block_size=block, blocks_per_batch=8, resident_batches=2)
    gen = REG.generator(config["generator"])
    a, b = gen.generate(config, SEED, CPU), gen.generate(config, SEED, CPU)
    other = gen.generate(config, SEED + 1, CPU)
    assert a.dtype == torch.uint8 and tuple(a.shape) == (16, block)
    assert torch.equal(a, b) and not torch.equal(a, other)


def test_every_seed_gives_the_corpus_files_the_same_share():
    config = small("corpus_64k", blocks_per_batch=8, resident_batches=2)
    total = sum((corpus.CORPUS / f).stat().st_size for f in config["files"])
    for seed in (0, 1, 9, SEED):
        cat = corpus.concatenation(config["files"], seed)
        assert len(cat) == total
        assert cat.tobytes() in (corpus.concatenation(config["files"], 0).tobytes() * 2)
    block = corpus.generate(config, 3, CPU).reshape(-1).numpy().tobytes()
    cat = corpus.concatenation(config["files"], 3).tobytes() * 2
    assert block[:4096] in cat


def parse(stream: bytes, limit: int):
    """The first ``limit`` rows of a serialized UnsafeRow stream as field
    lists, read back by the layout's rules."""
    rows, at = [], 0
    while len(rows) < limit:
        (size,) = struct.unpack_from(">i", stream, at)
        row = stream[at + 4 : at + 4 + size]
        at += 4 + size
        nulls, *slots = struct.unpack_from("<q16q", row)
        assert nulls == 0 and size % 8 == 0

        def text(slot):
            off, n = slot >> 32, slot & 0xFFFFFFFF
            assert off % 8 == 0 and off + n <= size and not any(row[off + n : -(-(off + n) // 8) * 8])
            return row[off : off + n].decode()

        rows.append([text(s) if i in (8, 9, 13, 14, 15) else s for i, s in enumerate(slots)])
    return rows


def test_lineitem_rows_read_back_field_by_field():
    config = small("shuffle_32k", blocks_per_batch=8, resident_batches=2)
    stream = lineitem.table(config, CPU).reshape(-1).numpy().tobytes()
    rows = parse(stream, 300)
    sf = config["scale_factor"]
    pool = lineitem.text_pool(config["text_pool_bytes"]).tobytes().decode()
    for (okey, pkey, skey, line, qty, price, disc, tax, rflag, status, ship, commit, receipt, instr, mode,
         comment) in rows:
        assert 1 <= okey and (okey - 1) % 32 < 8
        assert 1 <= pkey <= 200_000 * sf and 1 <= skey <= 10_000 * sf and 1 <= line <= 7
        assert qty % 100 == 0 and 1 <= qty // 100 <= 50
        retail = 90000 + (pkey // 10) % 20001 + 100 * (pkey % 1000)
        assert price == qty // 100 * retail and 0 <= disc <= 10 and 0 <= tax <= 8
        assert ship < receipt <= ship + 30 and lineitem.START_DATE < ship
        assert rflag == ("N" if receipt > lineitem.CURRENT_DATE else rflag) and rflag in "RAN"
        assert status == ("O" if ship > lineitem.CURRENT_DATE else "F")
        assert commit - ship <= 89 and instr in lineitem.SHIPINSTRUCT and mode in lineitem.SHIPMODE
        assert 10 <= len(comment) <= 43 and comment in pool
    keys = [r[0] for r in rows]
    assert keys == sorted(keys)
    lines = [r[3] for r in rows]
    assert all(b == a + 1 or b == 1 for a, b in zip(lines, lines[1:]))


def test_every_seed_deals_out_the_same_lineitem_blocks():
    config = small("shuffle_32k", blocks_per_batch=8, resident_batches=2)
    blocks = lineitem.table(config, CPU)
    for seed in (0, SEED):
        dealt = lineitem.generate(config, seed, CPU)
        order = [next(i for i in range(len(blocks)) if torch.equal(row, blocks[i])) for row in dealt]
        assert sorted(order) == list(range(len(blocks)))


def test_text_pool_is_fixed_and_sized():
    a = lineitem.text_pool(5000)
    assert len(a) == 5000 and np.array_equal(a, lineitem.text_pool(5000))
    words = set(a.tobytes().decode().replace(",", " ").split()[:-1])  # the last may be cut
    known = set(" ".join(lineitem.NOUNS + lineitem.VERBS + lineitem.ADJECTIVES + lineitem.ADVERBS
                         + lineitem.PREPOSITIONS + lineitem.AUXILIARIES).replace("_", " ").split()) | {"the"}
    assert {w.rstrip(".;:?!-") for w in words} - {""} <= known
