"""The batched raw-stream decoder (``parallel/distributed.py::
decompress_streams``) on the CPU: its plain K4 and ragged K1 against the
plain reference (``cpu/streams_reference.py``), the native scan and the
native decoder.

The streams are libsnappy-parse streams of seeded corpus slices and the
crafted streams of ``stream_cases``: copies that cross a 64 KiB mark (one
boundary merged away, or three), a literal across the mark, streams that
cannot be segmented (a literal over 0x1fff8 bytes, an offset over 0x1ffff,
a merge past 128 KiB), empty streams, a byte after the last tag, and the
faults (a cut stream, offset 0, a copy before the start, a literal past the
end, a cut copy trailer, a stated length the header disagrees with, a
header of six bytes, more tags than the header's length). They lie at
seeded, unaligned offsets of one buffer, their outputs at unaligned
offsets of another.

Tolerance: exact; the outputs are bytes and flags.
"""

import numpy as np
import pytest
import torch

from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.cpu import streams_reference
from snappy_tpu_torch.native import runtime as nat
from snappy_tpu_torch.ops import cuda_decode, cuda_segment, decode_torch
from snappy_tpu_torch.ops.host import pack_rows
from snappy_tpu_torch.parallel import distributed
from snappy_tpu_torch.utils import profiling

import stream_cases
from conftest import read_testdata

CRAFTED = stream_cases.crafted()


def assert_decoded(cases, args, out, ok):
    """Each case's ok flag is as expected, and an ok stream's bytes are its
    own."""
    for (cid, _, stated, want), o0, k in zip(cases, args[4].tolist(), ok.tolist()):
        assert k == (want is not None), cid
        if k:
            assert bytes(out[o0 : o0 + stated].numpy()) == want, cid


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_streams_decode_as_the_reference_does(seed):
    cases = stream_cases.native(seed, 6) + CRAFTED
    order = np.random.default_rng(seed).permutation(len(cases))
    cases = [cases[i] for i in order]
    args = stream_cases.lay_out(cases, seed)
    out, ok = distributed.decompress_streams(*args)
    ref_out, ref_ok = streams_reference.decompress_streams(*args)
    assert out.dtype == torch.uint8 and out.shape == (args[5],) and ok.dtype == torch.bool
    np.testing.assert_array_equal(ok.numpy(), ref_ok.numpy())
    assert_decoded(cases, args, out, ok)
    assert_decoded(cases, args, ref_out, ref_ok)


def test_streams_decode_as_the_reference_package_does():
    # The JAX package's raw-stream decoder, one stream a call: ok where it
    # decodes without fault to the stated length. It departs on one stream
    # as its array decoder does on a fixed row (``test_torch_decode.py::
    # test_truncated_copy_trailer``): a COPY_2 whose last offset byte is
    # cut off reads the zero padding there, where the port, as the block
    # kernel K1, refuses it.
    from snappy_tpu.core.errors import CorruptInputError as RefCorruptInputError
    from snappy_tpu.ops import host as ref_host

    cases = stream_cases.native(9, 4) + CRAFTED
    args = stream_cases.lay_out(cases, 9)
    out, ok = distributed.decompress_streams(*args)
    for (cid, stream, stated, _), o0, k in zip(cases, args[4].tolist(), ok.tolist()):
        try:
            want = ref_host.uncompress(stream)
        except RefCorruptInputError:
            want = None
        if cid == "copy-trailer-cut":
            assert not k and want is not None and len(want) == stated
            continue
        assert k == (want is not None and len(want) == stated), cid
        if k:
            assert bytes(out[o0 : o0 + stated].numpy()) == want, cid


def test_a_corrupt_stream_touches_only_itself():
    cases = stream_cases.native(4, 8)
    args = stream_cases.lay_out(cases, 4)
    clean, clean_ok = distributed.decompress_streams(*args)
    assert clean_ok.all()
    comp = args[0].clone()
    victim = 5
    start, clen = int(args[1][victim]), int(args[2][victim])
    tail = clen - clen // 2
    comp[start + clen // 2 : start + clen] = torch.tensor([0x12, 0, 0] * tail, dtype=torch.uint8)[:tail]  # offset 0
    out, ok = distributed.decompress_streams(comp, *args[1:])
    assert ok.tolist() == [i != victim for i in range(len(cases))]
    assert_decoded(cases[:victim] + [(cases[victim][0], None, 0, None)] + cases[victim + 1 :], args, out, ok)


@pytest.mark.parametrize("stated", [999, 1001, 0])
def test_a_header_that_disagrees_with_the_stated_length_is_not_ok(stated):
    good = stream_cases.native(5, 2)
    s = nat.compress(b"A" * 1000)
    cases = [good[0], ("liar", s, stated, None), good[1]]
    args = stream_cases.lay_out(cases, 5)
    out, ok = distributed.decompress_streams(*args)
    assert ok.tolist() == [True, False, True]
    assert_decoded(cases, args, out, ok)


def test_no_streams_and_empty_streams():
    none = (torch.zeros(0, dtype=torch.uint8), torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int32),
            torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int64), 0)
    out, ok = distributed.decompress_streams(*none)
    assert out.shape == (0,) and ok.shape == (0,)
    cases = [("empty", b"\x00", 0, b"")] * 3
    args = stream_cases.lay_out(cases, 6)
    out, ok = distributed.decompress_streams(*args)
    assert ok.all() and out.shape == (args[5],)


def test_streams_outside_their_buffers_are_not_ok():
    cases = stream_cases.native(7, 4)
    comp, starts, clens, ulens, outs, out_len = stream_cases.lay_out(cases, 7)
    starts, outs, clens = starts.clone(), outs.clone(), clens.clone()
    starts[0] = -1
    outs[1] = out_len - int(ulens[1]) + 1
    clens[2] = comp.numel()
    out, ok = distributed.decompress_streams(comp, starts, clens, ulens, outs, out_len)
    assert ok.tolist() == [False, False, False, True]


def test_arguments_of_the_wrong_kind_raise():
    args = list(stream_cases.lay_out(stream_cases.native(8, 2), 8))
    with pytest.raises(TypeError):
        distributed.decompress_streams(args[0], args[1].int(), *args[2:])
    with pytest.raises(TypeError):
        distributed.decompress_streams(args[0][None, :], *args[1:])
    with pytest.raises(ValueError):
        distributed.decompress_streams(*args[:5], -1)


SCAN_CASES = [(cid, stream, stated) for cid, stream, stated, _ in CRAFTED]
SCAN_CASES += [(f"file-{name}", nat.compress(read_testdata(name)), len(read_testdata(name)))
               for name in ("alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf", "lcet10.txt",
                            "geo.protodata", "kppkn.gtb", "sample-tweet.json")]
SCAN_CASES.append(("file-alice29.snappy", read_testdata("alice29.snappy"), len(read_testdata("alice29.txt"))))


@pytest.mark.parametrize("cid,stream,stated", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_plain_k4_cuts_as_the_native_scan_does(cid, stream, stated):
    want = stream_cases.native_scan(stream, stated)
    args = stream_cases.lay_out([(cid, stream, stated, None)], 9)
    capacity = cuda_segment.capacity_for(1, args[5])
    (ins, outs, clens, ulens, streams), ok, stats = cuda_segment.segment_streams_plain(*args, capacity)
    assert bool(ok[0]) == (want != "corrupt")
    used = int(stats[1])
    body = stream_cases.body_of(stream)
    assert int(stats[0]) == (cuda_segment.reserve(stated) if body and body[1] == stated else 0)
    if want == "corrupt":
        assert used == 0
        return
    body_at = int(args[1][0]) + len(stream) - len(body[0])
    if want == "whole":
        assert used == 1 and int(stats[3]) == 1
        assert (int(ins[0]), int(clens[0]), int(ulens[0])) == (body_at, len(body[0]), stated)
        return
    starts, oplens = want
    assert used == len(starts) and int(stats[3]) == 0
    assert (ins[:used] - body_at).tolist() == starts
    assert ulens[:used].tolist() == oplens
    assert (outs[:used] - int(args[4][0])).tolist() == (np.cumsum(oplens) - oplens).tolist()
    assert int(clens[:used].sum()) == (len(body[0]) if used else 0)
    assert (streams[: int(stats[0])] == 0).all()


def test_merges_and_whole_streams_are_counted():
    by_id = {c[0]: c for c in CRAFTED}
    cases = [by_id[i] for i in ("merge-one", "merge-thrice", "merge-late", "whole-long-literal", "whole-past-128k")]
    before = profiling.counters()
    out, ok = distributed.decompress_streams(*stream_cases.lay_out(cases, 10))
    moved = profiling.since(before)
    assert ok.all()
    assert moved["streams.streams"] == 5 and moved["streams.merged"] == 5 and moved["streams.whole"] == 2
    assert moved["streams.segments"] == 2 + 2 + 2 + 1 + 1


def test_the_ragged_walk_decodes_as_fixed_rows():
    cases = stream_cases.native(12, 6) + CRAFTED
    args = stream_cases.lay_out(cases, 12)
    comp, out_len = args[0], args[5]
    capacity = cuda_segment.capacity_for(len(cases), out_len)
    rows, k4_ok, stats = cuda_segment.segment_streams_plain(*args, capacity)
    n = int(stats[0])
    out = torch.zeros(out_len, dtype=torch.uint8)
    ragged_ok, ragged_total = cuda_decode.decode_segments_plain(comp, rows, n, out, k4_ok.clone())
    ins, outs, clens, ulens = (r[:n].numpy() for r in rows[:4])
    fixed = pack_rows(comp.numpy(), ins, clens)
    out_size = max(int(ulens.max()), 1)
    f_out, f_ok, f_total = decode_torch.decode_blocks(torch.from_numpy(fixed), torch.from_numpy(clens),
                                                      torch.from_numpy(ulens), out_size)
    np.testing.assert_array_equal(ragged_ok[:n].numpy(), f_ok.numpy())
    np.testing.assert_array_equal(ragged_total[:n].numpy()[f_ok.numpy()], f_total.numpy()[f_ok.numpy()])
    for i in range(n):
        assert torch.equal(out[outs[i] : outs[i] + ulens[i]], f_out[i, : ulens[i]])


def test_the_reference_decodes_as_the_native_decoder():
    for cid, stream, stated, want in CRAFTED + stream_cases.native(13, 4):
        body = stream_cases.body_of(stream)
        if body is None or body[1] != stated:
            continue
        try:
            native = nat.uncompress(stream)
        except CorruptInputError:
            native = None
        got = streams_reference.decode_body(torch.frombuffer(bytearray(body[0]) or bytearray(1),
                                                             dtype=torch.uint8)[: len(body[0])], stated)
        got = None if got is None else bytes(got.numpy())
        assert got == want, cid
        if cid != "copy-trailer-cut":  # the native decoder reads a cut trailer's missing byte as 0
            assert got == native, cid


def test_spans_and_counters_record_and_spans_stay_silent_when_tracing_is_off():
    args = stream_cases.lay_out(stream_cases.native(14, 3), 14)
    names = ("streams.decompress", "k4.segment_streams", "k1.decode_blocks")
    before_spans = {n: len(profiling.spans(n)) for n in names}
    before = profiling.counters()
    distributed.decompress_streams(*args)
    assert {n: len(profiling.spans(n)) for n in names} == before_spans
    moved = profiling.since(before)
    assert moved["streams.streams"] == 3 and moved["streams.segments"] >= 3
    with profiling.recording():
        distributed.decompress_streams(*args)
    spans = {n: profiling.spans(n)[-1] for n in names}
    outer = spans["streams.decompress"]
    for inner in ("k4.segment_streams", "k1.decode_blocks"):
        assert spans[inner].parent == outer.id
        assert outer.start_ns <= spans[inner].start_ns <= spans[inner].end_ns <= outer.end_ns
