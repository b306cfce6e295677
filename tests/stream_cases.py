"""Raw Snappy streams for the batched stream decoder's tests
(``decompress_streams``, K4 and K1's ragged variant): libsnappy-parse
streams of corpus slices from the native encoder, and streams crafted tag
by tag at the segmenter's edges. Each case is (id, whole stream with its
varint header, the length the caller states, the bytes it decodes to or
None where it is corrupt)."""

from __future__ import annotations

import numpy as np
import torch

from snappy_tpu.core.errors import CorruptInputError as RefCorruptInputError
from snappy_tpu.native import runtime as ref_nat
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.native import runtime as nat

from conftest import read_testdata
from torch_helpers import copy1, copy2, lit

SEG = 1 << 16
CORPUS = ["alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf", "kppkn.gtb", "geo.protodata"]


def long_literal(data: bytes) -> bytes:
    """A literal tag with a 3-byte length trailer."""
    return bytes([62 << 2]) + (len(data) - 1).to_bytes(3, "little") + data


def copy4(length: int, off: int) -> bytes:
    return bytes([0x03 | ((length - 1) << 2)]) + off.to_bytes(4, "little")


def _stream(body: bytes, out: bytes) -> bytes:
    return varint.encode32(len(out)) + body


def _noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def crafted() -> list[tuple[str, bytes, int, bytes | None]]:
    cases = []
    # A copy that reaches behind the second segment's start: merged.
    blk = bytes([1]) * SEG
    out = blk + blk[-100:-96] + b"abcd"
    cases.append(("merge-one", _stream(long_literal(blk) + copy1(4, 100) + lit(b"abcd"), out), len(out), out))
    # Three copies in a row, each at a new segment's start and reaching
    # behind it: three boundaries merged away.
    out = _noise(SEG, 1)
    for _ in range(3):
        out += out[-100:-96]
    out += b"abcd"
    body = long_literal(out[:SEG]) + copy1(4, 100) * 3 + lit(b"abcd")
    cases.append(("merge-thrice", _stream(body, out), len(out), out))
    # A merge in a later segment, after a copy that stays in its own.
    a, b, c = _noise(SEG, 2), _noise(SEG - 40, 3), _noise(30_000, 4)
    body = long_literal(a) + long_literal(b) + copy2(8, 20) + long_literal(c) + copy2(16, 60_000)
    out = a + b + (a + b)[-20:-12] + c
    out += out[-60_000:-60_000 + 16]
    cases.append(("merge-late", _stream(body, out), len(out), out))
    # A literal across the 64 KiB mark: a segment of up to 128 KiB.
    big = bytes(range(256)) * 512
    body = b"".join(long_literal(big[x:y]) for x, y in ((0, 2000), (2000, 67000), (67000, len(big))))
    cases.append(("literal-across-the-mark", _stream(body, big), len(big), big))
    # Not segmentable, so one row: a literal over 0x1fff8 bytes, a copy
    # offset over 0x1ffff, a merge that would pass 128 KiB.
    big = _noise(200_000, 4)
    cases.append(("whole-long-literal", _stream(long_literal(big), big), len(big), big))
    out = big + big[200_000 - 140_000 : 200_000 - 140_000 + 64]
    body = long_literal(big[:100_000]) + long_literal(big[100_000:]) + copy4(64, 140_000)
    cases.append(("whole-wide-offset", _stream(body, out), len(out), out))
    parts = [_noise(SEG - 8, 5 + i) for i in range(3)]
    body = b"".join(long_literal(p) for p in parts) + copy4(64, 70_000)
    out = b"".join(parts)
    out += out[-70_000:-70_000 + 64]
    cases.append(("whole-past-128k", _stream(body, out), len(out), out))
    # COPY_4 reaching back 69,000 bytes: merged, still segmented.
    big = _noise(70_000, 7)
    out = big + big[1000:1064]
    cases.append(("copy4-wide-merge", _stream(long_literal(big) + copy4(64, 69_000), out), len(out), out))
    # Empty streams; a stream with one byte after its last tag.
    cases.append(("empty", b"\x00", 0, b""))
    cases.append(("empty-one-stray-byte", b"\x00\x07", 0, b""))
    s = nat.compress(b"hello world " * 40)
    cases.append(("trailing-byte", s + b"\x01", 480, b"hello world " * 40))
    # Faults: a cut stream, offset 0, a copy before the start, a literal past
    # the end, a copy trailer cut short, a header that disagrees with the
    # stated length, a header of 6 bytes, more tags than the header's length.
    s = nat.compress(read_testdata("html"))
    cases.append(("cut", s[: len(s) // 2], len(read_testdata("html")), None))
    cases.append(("offset-zero", _stream(lit(b"abcd") + bytes([0x12, 0, 0]), b"x" * 9), 9, None))
    cases.append(("before-start", _stream(lit(b"abcd") + copy2(4, 9), b"x" * 8), 8, None))
    cases.append(("literal-past-end", varint.encode32(40) + bytes([39 << 2]) + b"ab", 40, None))
    base = bytes(range(60))
    cases.append(("copy-trailer-cut", _stream((lit(base) + copy2(64, 30) + copy2(64, 30))[:-1], b"x" * 188), 188,
                  None))
    s = nat.compress(b"A" * 1000)
    cases.append(("stated-999", s, 999, None))
    cases.append(("stated-1001", s, 1001, None))
    cases.append(("header-six-bytes", b"\x80\x80\x80\x80\x80\x00" + s[2:], 1000, None))
    cases.append(("more-than-the-header", varint.encode32(4) + lit(b"abcd") + lit(b"efgh"), 4, None))
    return cases


def native(seed: int, count: int) -> list[tuple[str, bytes, int, bytes]]:
    """``count`` libsnappy-parse streams of seeded corpus slices, 0 to
    300,000 bytes."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(count):
        raw = read_testdata(CORPUS[i % len(CORPUS)])
        n = int(rng.integers(0, min(len(raw), 300_000)))
        at = int(rng.integers(0, len(raw) - n + 1))
        cases.append((f"native-{i}", nat.compress(raw[at : at + n]), n, raw[at : at + n]))
    return cases


def lay_out(cases, seed: int, *, gap: int = 40, out_gap: int = 24):
    """The streams end to end in one buffer, each after a seeded gap of 0 to
    ``gap`` bytes (so at any offset), and their outputs after gaps of 0 to
    ``out_gap``: the arguments of ``decompress_streams`` as CPU tensors."""
    rng = np.random.default_rng(seed)
    buf, starts, outs, at = bytearray(), [], [], 0
    for _, stream, stated, _ in cases:
        buf += _noise(int(rng.integers(0, gap + 1)), int(rng.integers(1 << 30)))
        starts.append(len(buf))
        buf += stream
        at += int(rng.integers(0, out_gap + 1))
        outs.append(at)
        at += stated
    return (torch.frombuffer(bytearray(buf) or bytearray(1), dtype=torch.uint8)[: len(buf)].clone(),
            torch.tensor(starts, dtype=torch.int64),
            torch.tensor([len(c[1]) for c in cases], dtype=torch.int32),
            torch.tensor([c[2] for c in cases], dtype=torch.int32),
            torch.tensor(outs, dtype=torch.int64), at)


def body_of(stream: bytes) -> tuple[bytes, int] | None:
    """(headerless body, the length its header states) of a stream, or None
    where its header is not a varint32."""
    try:
        ulen, h = varint.parse32(np.frombuffer(stream, np.uint8), 0)
    except CorruptInputError:
        return None
    return stream[h:], ulen


def native_scan(stream: bytes, stated: int):
    """What the reference's native ``scan_blocks`` (the JAX package's,
    whose rule K4 ports) makes of a whole stream stated to decode to
    ``stated`` bytes: "corrupt" (a header that is not a varint32 or not
    ``stated``, or a body the scan proves corrupt), "whole" (it declines),
    or (starts, oplens) as lists."""
    got = body_of(stream)
    if got is None or got[1] != stated:
        return "corrupt"
    try:
        scan = ref_nat.scan_blocks(np.frombuffer(got[0], np.uint8), stated)
    except RefCorruptInputError:
        return "corrupt"
    return "whole" if scan is None else (scan[0].tolist(), scan[1].tolist())
