"""The port's streaming pipeline (``snappy_tpu_torch/parallel/streaming.py``)
against snappy_tpu's, on the CPU.

The first part holds the port to every behaviour of
``tests/test_streaming.py``: frame sequences, recovery by re-dispatch, torn
streams and resume after a kill. The second holds it against the reference
itself: the same frame sequence for the same input, sequences that decode
in the other package, and files torn by one package that resume in the
other. For byte identity the reference encodes with K2 (interpret mode,
``contest=False``) patched in where a TPU would select it; round trips and
decodes need no patch. The port runs the plain versions of its kernels.

Tolerance: exact, since the outputs are bytes.
"""

import hashlib
import io

import numpy as np
import pytest
import torch

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.core.errors import CorruptInputError as RefCorruptInputError
from snappy_tpu.parallel import streaming as ref_streaming
from snappy_tpu_torch.core.errors import CorruptInputError
from snappy_tpu_torch.parallel import framed
from snappy_tpu_torch.parallel import host as phost
from snappy_tpu_torch.parallel import streaming

from conftest import read_testdata
from torch_helpers import config_from_reference, patch_reference_k2, reference_k2  # noqa: F401  (fixture)

BLOCK = 1 << 16


def compressed(raw: bytes, **kw) -> io.BytesIO:
    """The port's frame sequence of ``raw``, rewound."""
    dst = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), dst, device="cpu", **kw)
    dst.seek(0)
    return dst


def roundtrip(raw: bytes, **kw) -> bytes:
    out = io.BytesIO()
    n = streaming.uncompress_stream(compressed(raw, **kw), out, device="cpu")
    assert n == len(raw)
    return out.getvalue()


def mkdata(n: int = 5 * BLOCK + 777) -> bytes:
    """Words from a seed: compressible, and 6 blocks at the default size
    (the reference's resume tests' data)."""
    rng = np.random.RandomState(11)
    words = [bytes(rng.randint(0, 256, rng.randint(4, 17))) for _ in range(64)]
    return b"".join(words[rng.randint(0, 64)] for _ in range(n // 8))[:n]


# --- the behaviours of tests/test_streaming.py, on the port ---------------


def test_multi_frame_stream():
    raw = read_testdata("urls.10K") + read_testdata("html_x_4")  # ~1.1 MB, 17 blocks
    assert roundtrip(raw) == raw
    assert streaming.last_stats == {"frames": 1, "retries": 0}  # 32 blocks a frame
    assert roundtrip(raw, blocks_per_frame=8) == raw
    assert streaming.last_stats == {"frames": 3, "retries": 0}


def test_small_blocks_per_frame():
    raw = read_testdata("html")
    assert roundtrip(raw, blocks_per_frame=1) == raw


def test_empty_stream():
    assert compressed(b"").getvalue() == b""
    assert roundtrip(b"") == b""


def test_frame_iteration_offsets():
    raw = read_testdata("html_x_4") * 3  # ~1.2 MB
    frames = list(streaming.iter_frames(compressed(raw, blocks_per_frame=4)))
    assert len(frames) == -(-((len(raw) + BLOCK - 1) // BLOCK) // 4)
    # Decode from frame 2 on: recovery restarts at a frame boundary.
    partial = b"".join(snappy_tpu_torch.uncompress_framed(f, device="cpu") for f in frames[2:])
    assert partial == raw[2 * 4 * BLOCK :]


@pytest.fixture(scope="module")
def html_x_4_in_pairs():
    raw = read_testdata("html_x_4")
    return raw, compressed(raw, blocks_per_frame=2).getvalue()


def test_transient_frame_failure_recovers(monkeypatch, html_x_4_in_pairs):
    """A frame whose decode fails once is dispatched again and decodes."""
    raw, seq = html_x_4_in_pairs
    real = phost.assemble_uncompress_array
    fail_once = {"armed": True}

    def flaky(ticket):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("injected transient device fault")
        return real(ticket)

    monkeypatch.setattr(phost, "assemble_uncompress_array", flaky)
    out = io.BytesIO()
    n = streaming.uncompress_stream(io.BytesIO(seq), out, device="cpu")
    assert n == len(raw) and out.getvalue() == raw
    assert streaming.last_stats == {
        "frames": 4,
        "retries": 1,
        "last_retry_exception": "RuntimeError",
    }


def test_corrupt_frame_does_not_retry(monkeypatch, html_x_4_in_pairs):
    """Corrupt data fails the same way every time: no second dispatch."""
    calls = {"n": 0}

    def corrupt(ticket):
        calls["n"] += 1
        raise CorruptInputError("injected corruption")

    monkeypatch.setattr(phost, "assemble_uncompress_array", corrupt)
    with pytest.raises(CorruptInputError):
        streaming.uncompress_stream(io.BytesIO(html_x_4_in_pairs[1]), io.BytesIO(), device="cpu")
    assert calls["n"] == 1


def test_reference_corrupt_error_is_retried(monkeypatch, html_x_4_in_pairs):
    """Only the port's own CorruptInputError is final: the reference's class
    is another exception to the port, so it is dispatched again."""
    real = phost.assemble_uncompress_array
    calls = {"n": 0}

    def foreign(ticket):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RefCorruptInputError("the other package's class")
        return real(ticket)

    monkeypatch.setattr(phost, "assemble_uncompress_array", foreign)
    out = io.BytesIO()
    streaming.uncompress_stream(io.BytesIO(html_x_4_in_pairs[1]), out, device="cpu")
    assert out.getvalue() == html_x_4_in_pairs[0]
    assert streaming.last_stats["retries"] == 1


def test_persistent_frame_failure_raises(monkeypatch, html_x_4_in_pairs):
    calls = {"n": 0}

    def broken(ticket):
        calls["n"] += 1
        raise RuntimeError("injected permanent fault")

    monkeypatch.setattr(phost, "assemble_uncompress_array", broken)
    with pytest.raises(RuntimeError, match="permanent"):
        streaming.uncompress_stream(io.BytesIO(html_x_4_in_pairs[1]), io.BytesIO(), device="cpu", max_retries=2)
    assert calls["n"] == 3


def test_torn_stream_raises():
    data = compressed(b"x" * 300000).getvalue()
    for cut in [3, len(data) - 5]:
        with pytest.raises(CorruptInputError):
            streaming.uncompress_stream(io.BytesIO(data[:cut]), io.BytesIO(), device="cpu")


def test_cuda_without_a_card_raises():
    """The entry points run on the card unless the caller names the CPU;
    without a card they raise and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        streaming.compress_stream(io.BytesIO(b"abc" * 1000), io.BytesIO())
    with pytest.raises(RuntimeError):
        streaming.uncompress_stream(compressed(b"abc" * 1000), io.BytesIO())


class TestKillAndResume:
    """The frame sequence is its own checkpoint: a killed run restarts from
    the last durable frame."""

    def test_resume_compress_after_torn_tail(self, tmp_path):
        raw = mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        ref = tmp_path / "ref.snpf"
        streaming.compress_file(str(src), str(ref), blocks_per_frame=2, device="cpu")
        full = ref.read_bytes()

        for cut_frac in (0.25, 0.6, 0.97):
            out = tmp_path / f"out{cut_frac}.snpf"
            out.write_bytes(full[: int(len(full) * cut_frac)])  # the kill
            size = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
            assert size == len(full)
            assert out.read_bytes() == full

    def test_resume_compress_from_scratch_and_idempotent(self, tmp_path):
        src = tmp_path / "in.bin"
        src.write_bytes(mkdata())
        out = tmp_path / "out.snpf"
        s1 = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
        first = out.read_bytes()
        s2 = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
        assert (s1, first) == (s2, out.read_bytes())
        assert s1 == len(first)

    def test_resume_uncompress_after_torn_output(self, tmp_path):
        raw = mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        comp = tmp_path / "c.snpf"
        streaming.compress_file(str(src), str(comp), blocks_per_frame=2, device="cpu")

        for cut in (None, 0, 100, 3 * BLOCK + 5, len(raw) - 3):
            out = tmp_path / f"o{cut}.bin"
            if cut is not None:
                out.write_bytes(raw[:cut])  # the output a kill left
            n = streaming.resume_uncompress_file(str(comp), str(out), device="cpu")
            assert n == len(raw)
            assert out.read_bytes() == raw

    def test_resume_compress_after_input_grew(self, tmp_path):
        """A finished stream ends in a short frame; where the input then
        grows, resume drops that frame and goes on."""
        raw = mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        out = tmp_path / "out.snpf"
        streaming.compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
        src.write_bytes(raw + mkdata(3 * BLOCK + 99))
        size = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
        ref = tmp_path / "ref.snpf"
        streaming.compress_file(str(src), str(ref), blocks_per_frame=2, device="cpu")
        assert size == len(ref.read_bytes())
        assert out.read_bytes() == ref.read_bytes()

    def test_resume_compress_finished_truncates_torn_tail(self, tmp_path):
        src = tmp_path / "in.bin"
        src.write_bytes(mkdata())
        out = tmp_path / "out.snpf"
        streaming.compress_file(str(src), str(out), blocks_per_frame=2, device="cpu")
        full = out.read_bytes()
        out.write_bytes(full + b"\x99" * 7)  # killed while appending
        assert streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2, device="cpu") == len(full)
        assert out.read_bytes() == full

    def test_scan_durable_frames_counts(self, tmp_path):
        raw = mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        comp = tmp_path / "c.snpf"
        streaming.compress_file(str(src), str(comp), blocks_per_frame=2, device="cpu")
        full = comp.read_bytes()
        durable, nf, covered = streaming.scan_durable_frames(str(comp))
        assert durable == len(full) and covered == len(raw) and nf == 3
        comp.write_bytes(full[:-1])  # torn tail: the last frame is not durable
        d2, nf2, c2 = streaming.scan_durable_frames(str(comp))
        assert nf2 == 2 and d2 < len(full) and c2 == 4 * BLOCK
        assert streaming.scan_durable_frames(str(tmp_path / "missing")) == (0, 0, 0)


# --- against the reference ------------------------------------------------

# (input, blocks_per_frame, frame config) of the byte-identity cases, three
# frames of two blocks each, the last short: words; and a text block beside
# a jpeg block (routed to the host encoder), then text, without crcs.
SEQUENCES = {
    "words": (mkdata(), 2, RefFrameConfig()),
    "routed-nocrc": (
        read_testdata("html")[:BLOCK] + read_testdata("fireworks.jpeg")[:BLOCK] + read_testdata("alice29.txt")[: 2 * BLOCK + 30000],
        2,
        RefFrameConfig(checksum=False),
    ),
}


@pytest.fixture(scope="module")
def sequences():
    """Each case's frame sequence from the port and from the reference with
    K2, and the reference's from its own CPU encoder."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_reference_k2(mp)
        for key, (raw, bpf, cfg) in SEQUENCES.items():
            ref = io.BytesIO()
            ref_streaming.compress_stream(io.BytesIO(raw), ref, config=cfg, blocks_per_frame=bpf)
            out[key] = {"ref_k2": ref.getvalue()}
    for key, (raw, bpf, cfg) in SEQUENCES.items():
        port = compressed(raw, blocks_per_frame=bpf, config=config_from_reference(cfg))
        ref = io.BytesIO()
        ref_streaming.compress_stream(io.BytesIO(raw), ref, config=cfg, blocks_per_frame=bpf)
        out[key].update(port=port.getvalue(), ref_own=ref.getvalue())
    return out


@pytest.mark.parametrize("key", list(SEQUENCES))
def test_sequence_identical_to_reference(sequences, key):
    seqs = sequences[key]
    assert seqs["port"] == seqs["ref_k2"]
    assert len(list(streaming.iter_frames(io.BytesIO(seqs["port"])))) == 3


@pytest.mark.parametrize("key", list(SEQUENCES))
def test_sequences_decode_in_the_other_package(sequences, key):
    raw = SEQUENCES[key][0]
    out = io.BytesIO()
    assert ref_streaming.uncompress_stream(io.BytesIO(sequences[key]["port"]), out) == len(raw)
    assert out.getvalue() == raw
    out = io.BytesIO()
    assert streaming.uncompress_stream(io.BytesIO(sequences[key]["ref_own"]), out, device="cpu") == len(raw)
    assert out.getvalue() == raw
    assert streaming.last_stats == {"frames": 3, "retries": 0}


def _cuts(seq: bytes) -> list[int]:
    """Lengths around every part of every frame of ``seq``: inside and at
    the ends of each header, index and payload."""
    cuts, off = set(), 0
    for frame in streaming.iter_frames(io.BytesIO(seq)):
        n_blocks = framed._HEADER.unpack_from(frame, 0)[4]
        index_end = framed._HEADER.size + 4 * n_blocks * (2 if frame[8] & framed.FLAG_CRC else 1)
        for k in (1, 8, framed._HEADER.size - 1, framed._HEADER.size, framed._HEADER.size + 1,
                  index_end - 1, index_end, index_end + 1, len(frame) - 1):
            cuts.add(off + k)
        off += len(frame)
    return sorted(cuts | {0, off})


@pytest.mark.parametrize("key", list(SEQUENCES))
def test_frame_reader_as_the_reference_on_torn_files(sequences, key, tmp_path):
    """The port reads header and index in one place where the reference
    has three parsers: scans, chunk prefixes and iteration agree with the
    reference's on a file cut anywhere in a frame, and on a bad magic."""
    seq = sequences[key]["port"]
    chunk = SEQUENCES[key][1] * BLOCK
    path = tmp_path / "torn.snpf"
    for cut in _cuts(seq):
        path.write_bytes(seq[:cut])
        assert streaming.scan_durable_frames(str(path)) == ref_streaming.scan_durable_frames(str(path)), cut
        assert streaming._full_chunk_prefix(str(path), chunk) == ref_streaming._full_chunk_prefix(str(path), chunk)
        try:
            want = list(ref_streaming.iter_frames(io.BytesIO(seq[:cut])))
        except RefCorruptInputError as e:
            with pytest.raises(CorruptInputError, match=str(e)):
                list(streaming.iter_frames(io.BytesIO(seq[:cut])))
        else:
            assert list(streaming.iter_frames(io.BytesIO(seq[:cut]))) == want
    first = len(next(streaming.iter_frames(io.BytesIO(seq))))
    bad = bytearray(seq)
    bad[first] ^= 0xFF  # the second frame's magic
    path.write_bytes(bytes(bad))
    for pkg, exc in ((streaming, CorruptInputError), (ref_streaming, RefCorruptInputError)):
        with pytest.raises(exc, match="bad frame magic"):
            pkg.scan_durable_frames(str(path))
        with pytest.raises(exc, match="bad frame magic"):
            list(pkg.iter_frames(io.BytesIO(bytes(bad))))


@pytest.mark.parametrize("cut_frac", [0.25, 0.6, 0.97])
def test_reference_torn_file_resumes_in_the_port(sequences, tmp_path, cut_frac):
    raw, bpf, cfg = SEQUENCES["words"]
    full = sequences["words"]["ref_k2"]
    src, out = tmp_path / "in.bin", tmp_path / "out.snpf"
    src.write_bytes(raw)
    out.write_bytes(full[: int(len(full) * cut_frac)])
    size = streaming.resume_compress_file(
        str(src), str(out), config=config_from_reference(cfg), blocks_per_frame=bpf, device="cpu"
    )
    assert size == len(full) and out.read_bytes() == full


@pytest.mark.parametrize("cut_frac", [0.25, 0.6, 0.97])
def test_port_torn_file_resumes_in_the_reference(reference_k2, sequences, tmp_path, cut_frac):
    raw, bpf, cfg = SEQUENCES["words"]
    full = sequences["words"]["port"]
    src, out = tmp_path / "in.bin", tmp_path / "out.snpf"
    src.write_bytes(raw)
    out.write_bytes(full[: int(len(full) * cut_frac)])
    size = ref_streaming.resume_compress_file(str(src), str(out), config=cfg, blocks_per_frame=bpf)
    assert size == len(full) and out.read_bytes() == full


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_torn_output_resumes_across_packages(sequences, tmp_path, writer):
    """An output torn by one package's decode is finished by the other's
    resume."""
    raw = SEQUENCES["words"][0]
    comp = tmp_path / "c.snpf"
    comp.write_bytes(sequences["words"]["ref_own" if writer == "reference" else "port"])
    first = tmp_path / "first.bin"
    if writer == "reference":
        ref_streaming.uncompress_file(str(comp), str(first))
        resume = lambda out: streaming.resume_uncompress_file(str(comp), str(out), device="cpu")  # noqa: E731
    else:
        streaming.uncompress_file(str(comp), str(first), device="cpu")
        resume = lambda out: ref_streaming.resume_uncompress_file(str(comp), str(out))  # noqa: E731
    assert first.read_bytes() == raw
    for cut in (0, 100, 2 * BLOCK, 3 * BLOCK + 5, len(raw) - 3):
        out = tmp_path / f"o{cut}.bin"
        out.write_bytes(raw[:cut])
        assert resume(out) == len(raw)
        assert out.read_bytes() == raw


def test_reference_frame_sequence_through_the_port_framed_reader(sequences):
    """Each frame of a reference sequence is a frame the port's framed
    decoder reads on its own, and one frame alone is a one-frame stream."""
    raw = SEQUENCES["routed-nocrc"][0]
    frames = list(ref_streaming.iter_frames(io.BytesIO(sequences["routed-nocrc"]["ref_own"])))
    assert b"".join(snappy_tpu_torch.uncompress_framed(f, device="cpu") for f in frames) == raw
    one = snappy_tpu.compress_framed(raw[:1000])
    out = io.BytesIO()
    assert streaming.uncompress_stream(io.BytesIO(one), out, device="cpu") == 1000
    assert out.getvalue() == raw[:1000]


# --- what a sink is given -------------------------------------------------
# The reference hands ``dst.write`` one ``bytes`` a frame; the port hands it
# a memoryview of the host memory the frame came back in. Whatever a sink
# does with bytes must work with it, and a part it keeps must stay as it was.

SINK_RAW = read_testdata("html") * 3  # 307,200 bytes: 10 frames of 8 blocks of 4 KiB
SINK_CONFIG = RefFrameConfig(block_size=4096)
SINK_BLOCKS_PER_FRAME = 8


class ConcatSink:
    """``self.buf += d`` on a ``bytes`` (or, with ``bytearray()``, a
    ``bytearray``) buffer."""

    def __init__(self, buf):
        self.buf = buf

    def write(self, d):
        self.buf += d
        return len(d)

    def value(self) -> bytes:
        return bytes(self.buf)


class KeepSink:
    """Keeps every part it is given, and a copy of it taken at once."""

    def __init__(self):
        self.parts, self.copies = [], []

    def write(self, d):
        self.parts.append(d)
        self.copies.append(bytes(d))
        return len(d)

    def value(self) -> bytes:
        return b"".join(self.parts)


class HashSink:
    def __init__(self):
        self.h = hashlib.sha256()

    def write(self, d):
        self.h.update(d)
        return len(d)

    def value(self) -> bytes:
        return self.h.digest()


class BytesIOSink(io.BytesIO):
    def value(self) -> bytes:
        return self.getvalue()


class FileSink:
    def __init__(self, path):
        self.path = path
        self.f = open(path, "wb")

    def write(self, d):
        return self.f.write(d)

    def value(self) -> bytes:
        self.f.close()
        return self.path.read_bytes()


SINKS = {
    "bytes": lambda path: ConcatSink(b""),
    "bytearray": lambda path: ConcatSink(bytearray()),
    "list": lambda path: KeepSink(),
    "sha256": lambda path: HashSink(),
    "BytesIO": lambda path: BytesIOSink(),
    "file": lambda path: FileSink(path),
}


@pytest.fixture(scope="module")
def sink_sequence():
    return compressed(SINK_RAW, config=config_from_reference(SINK_CONFIG),
                      blocks_per_frame=SINK_BLOCKS_PER_FRAME).getvalue()


@pytest.mark.parametrize("sink", list(SINKS))
def test_sinks_get_what_the_reference_gives(sink_sequence, tmp_path, sink):
    """The same frame sequence decoded by each package into the same kind
    of sink leaves the same bytes there; a list sink's parts equal the
    reference's, frame by frame, and none has changed by the end."""
    ref_sink, port_sink = SINKS[sink](tmp_path / "ref.out"), SINKS[sink](tmp_path / "port.out")
    assert ref_streaming.uncompress_stream(io.BytesIO(sink_sequence), ref_sink) == len(SINK_RAW)
    assert streaming.uncompress_stream(io.BytesIO(sink_sequence), port_sink, device="cpu") == len(SINK_RAW)
    want = hashlib.sha256(SINK_RAW).digest() if sink == "sha256" else SINK_RAW
    assert port_sink.value() == ref_sink.value() == want
    if sink == "list":
        assert len(port_sink.parts) == len(ref_sink.parts) == 10
        for ours, theirs, copy in zip(port_sink.parts, ref_sink.parts, port_sink.copies):
            assert ours == theirs and len(ours) == len(theirs)
            assert ours == copy


class KeptFile:
    """A file whose ``write`` also keeps every part it is given."""

    def __init__(self, f, parts: list):
        self._f, self.parts = f, parts

    def write(self, d):
        self.parts.append(d)
        return self._f.write(d)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)


def test_resume_writes_what_the_reference_writes(sink_sequence, tmp_path, monkeypatch):
    """``resume_uncompress_file`` after a torn output writes the same parts
    as the reference's: each one adds to ``bytes`` as the reference's do,
    and the file ends equal to the input."""
    comp = tmp_path / "c.snpf"
    comp.write_bytes(sink_sequence)
    cut = 3 * SINK_BLOCKS_PER_FRAME * 4096 + 1000  # inside the fourth frame
    parts = {}
    for name, pkg, kw in (("ref", ref_streaming, {}), ("port", streaming, {"device": "cpu"})):
        out = tmp_path / f"{name}.out"
        out.write_bytes(SINK_RAW[:cut])
        kept = parts[name] = []

        def keeping_open(path, mode="r", *a, _out=str(out), _kept=kept, **k):
            f = open(path, mode, *a, **k)
            return KeptFile(f, _kept) if str(path) == _out and "+" in mode else f

        monkeypatch.setattr(pkg, "open", keeping_open, raising=False)
        assert pkg.resume_uncompress_file(str(comp), str(out), **kw) == len(SINK_RAW)
        monkeypatch.undo()
        assert out.read_bytes() == SINK_RAW
    done = b""
    for ours, theirs in zip(parts["port"], parts["ref"], strict=True):
        done += ours
        assert ours == theirs
    assert done == SINK_RAW[3 * SINK_BLOCKS_PER_FRAME * 4096 :]
