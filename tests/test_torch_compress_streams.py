"""``parallel/distributed.py::compress_streams`` on the CPU: many pages of one
buffer written as raw Snappy streams in one call, by the plain versions of
K2's ragged entry and K5.

The pages lie in one buffer at odd offsets with gaps of 0 to 40 bytes
between them, and go through one call. Each page's stream must equal the
plain reference's (``cpu/streams_encode_reference.py``, each page alone) and
what ``ops/host.py::compress`` writes for it with no block routed to the
host, and must decode to the page under the plain reference decoder
(``cpu/streams_reference.py``), through ``distributed.decompress_streams``,
and under libsnappy where the machine has it. A page that does not lie in
the buffer, or has a negative length, makes the CPU call raise; the same
pieces as the card runs them (the fragment table, K2's plain rows, the
plain K5) give it clens -1 and leave every other page's stream as it was.
"""

import numpy as np
import pytest
import torch

from snappy_tpu_torch.cpu import streams_encode_reference, streams_reference
from snappy_tpu_torch.native import libsnappy
from snappy_tpu_torch.ops import cuda_encode, cuda_join, host, route
from snappy_tpu_torch.parallel import distributed

from conftest import read_testdata


def _cases() -> dict[str, bytes]:
    rng = np.random.default_rng(26)
    text = read_testdata("alice29.txt") + read_testdata("html")
    keys = np.repeat(np.arange(75_000_000, 75_000_000 + 4_000, dtype=np.int64) * 32 + 1, 5)
    prices = rng.integers(90_000, 10_500_000, 20_000, dtype=np.int64)
    return {
        "empty": b"",
        "one-byte": b"x",
        "65536": text[:65_536],
        "65537": text[1000:66_537],
        "corpus-200k": text[7:200_007],
        "zeros": bytes(70_000),
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "l_orderkey-int64": keys.astype("<i8").tobytes(),
        "l_extendedprice-int64": prices.astype("<i8").tobytes(),
        "short-text": text[500:1_300],
    }


CASES = _cases()


def _layout(pages):
    """The pages in one buffer, each after a gap of 0 to 40 bytes: (data,
    starts, ulens) as tensors."""
    rng = np.random.default_rng(2600)
    buf, starts = bytearray(), []
    for p in pages:
        buf += rng.integers(0, 256, int(rng.integers(0, 41)), dtype=np.uint8).tobytes()
        starts.append(len(buf))
        buf += p
    return (torch.frombuffer(bytearray(buf), dtype=torch.uint8), torch.tensor(starts, dtype=torch.int64),
            torch.tensor([len(p) for p in pages], dtype=torch.int32))


@pytest.fixture(scope="module")
def call():
    args = _layout(list(CASES.values()))
    comp, cstarts, clens = distributed.compress_streams(*args)
    streams = {name: comp[s : s + n].numpy().tobytes()
               for name, s, n in zip(CASES, cstarts.tolist(), clens.tolist())}
    return args, (comp, cstarts, clens), streams


@pytest.fixture(scope="module")
def unrouted():
    """``ops/host.py::compress`` of each page with no block routed to the host."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(route, "host_blocks", lambda buf, blens: np.zeros(0, np.int64))
        return {name: host.compress(page, device="cpu") for name, page in CASES.items()}


def test_streams_lie_end_to_end_within_the_bound(call):
    (data, _, ulens), (comp, cstarts, clens), _ = call
    assert comp.numel() == cuda_join.stream_bound(len(CASES), data.numel())
    assert (clens > 0).all() and cstarts[0] == 0
    assert torch.equal(cstarts[1:], cstarts[:-1] + clens[:-1].long())
    bound = 32 * ((ulens.long() + 65_535) // 65_536) + ulens.long() + ulens.long() // 6 + 5
    assert (clens.long() <= bound).all()


@pytest.mark.parametrize("name", list(CASES))
def test_stream_equals_the_plain_reference(call, name):
    page = torch.tensor(list(CASES[name]), dtype=torch.uint8)
    assert call[2][name] == streams_encode_reference.compress_page(page)


@pytest.mark.parametrize("name", list(CASES))
def test_stream_equals_unrouted_compress(call, unrouted, name):
    assert call[2][name] == unrouted[name]


def test_plain_reference_call_equals_the_program(call):
    args, (comp, cstarts, clens), _ = call
    r_comp, r_starts, r_lens = streams_encode_reference.compress_streams(*args)
    assert torch.equal(r_starts, cstarts) and torch.equal(r_lens, clens)
    assert torch.equal(r_comp, comp[: r_comp.numel()])


def test_streams_decode_to_their_pages(call):
    """Under the plain reference decoder and through decompress_streams, in
    one call over every stream."""
    (_, _, ulens), (comp, cstarts, clens), streams = call
    out_starts = torch.cumsum(ulens.long(), 0) - ulens.long()
    out_len = int(ulens.sum())
    want = b"".join(CASES.values())
    for decode in (streams_reference.decompress_streams, distributed.decompress_streams):
        out, ok = decode(comp, cstarts, clens, ulens, out_starts, out_len)
        assert bool(ok.all()), decode
        assert out.numpy().tobytes() == want, decode


@pytest.mark.skipif(not libsnappy.available(), reason="libsnappy is not installed")
@pytest.mark.parametrize("name", list(CASES))
def test_streams_decode_under_libsnappy(call, name):
    assert libsnappy.uncompress(call[2][name]) == CASES[name]


@pytest.mark.parametrize("bad", [(-1, 10), (None, 1), (5, -3)], ids=["before", "past-the-end", "negative"])
def test_refused_page_raises_on_the_cpu(bad):
    data, starts, ulens = _layout([CASES["short-text"], CASES["65537"]])
    s, n = bad
    starts[1] = data.numel() if s is None else s
    ulens[1] = n
    with pytest.raises(ValueError):
        distributed.compress_streams(data, starts, ulens)


def test_refused_pages_touch_no_other_page(call):
    """As a card runs the call: a page outside the buffer and one of negative
    length take no bytes and have clens -1; every other page's stream is
    the one the sound call wrote, end to end as before."""
    (data, starts, ulens), _, streams = call
    starts, ulens = starts.clone(), ulens.clone()
    starts[3], ulens[5] = data.numel() - 10, -1
    table = cuda_join.fragment_table(starts, ulens, data.numel())
    assert table.fcount[3] == table.fcount[5] == -1
    wide, narrow = table.wide, table.narrow
    rows = len(wide[0]) + len(narrow[0])
    frags = torch.empty((rows, cuda_encode.BLOCK_MAX_OUT), dtype=torch.uint8)
    olens = torch.empty(rows, dtype=torch.int32)
    cuda_encode.encode_fragments(data, *wide, 2, 1 << 16, frags[: len(wide[0])], olens[: len(wide[0])])
    cuda_encode.encode_fragments(data, *narrow, 2, 1 << 15, frags[len(wide[0]) :], olens[len(wide[0]) :])
    comp, cstarts, clens = cuda_join.join_streams(frags, olens, table.frow, table.ffirst, table.fcount, ulens,
                                                  cuda_join.stream_bound(len(starts), data.numel()))
    assert clens[3] == clens[5] == -1
    kept = [i for i in range(len(CASES)) if i not in (3, 5)]
    for i, name in enumerate(CASES):
        if i in kept:
            assert comp[cstarts[i] : cstarts[i] + clens[i]].numpy().tobytes() == streams[name], name
    kept_starts = cstarts[kept]
    assert torch.equal(kept_starts[1:], kept_starts[:-1] + clens[kept][:-1].long())
