#!/usr/bin/env python3
"""Drive snappy_tpu_torch's read and write paths, the decode A/B, the probes, the streaming pipeline, the mesh, the array encoder and the bench once on one CUDA GPU (Hopper, sm_90).

    python3 chip_smoke.py

Run from the root of the repository, with no arguments; it uses one card
(cuda:0). Phases, one line each (plus details), and any failure exits
non-zero:

  1. device   name, capability (must be 9.0), nvidia-smi name and power limit
  2. build    the native C++ codec (g++) and the CUDA kernels (one nvcc per
              source, all at once)
  3. kernel   the CUDA block decoder against its plain torch version on one
              batch on the card: 128 corpus blocks of 64 KiB, the corrupt
              battery, RLE blocks, wrong claimed lengths, a trailing byte,
              128 corpus blocks damaged at random (fixed seed); then rows
              whose lengths do not fit the batch, which the kernel refuses;
              then, at 128 KiB of output, the rows of
              tools/profile_decode.window_rows at the edges of the kernel's
              output window and compressed ring (copies from around the
              window's reach across flushes, overlapping copies, literals
              around the ring's size, a 128 KiB segment, text across flushes)
  4. slice    a 64 MiB corpus-mix frame (1024 blocks, crc on) through
              uncompress_framed(frame, device="cuda"): the main path; the
              kernel's launch counter is read just before and just after;
              the kernel's shared memory a block and blocks an SM
  5. raw      alice29.snappy, a 64 MiB native raw stream and an unsegmentable
              stream through uncompress(backend="torch", device="cuda");
              baddata{1,2,3}.snappy must raise CorruptInputError
  6. corrupt  a frame with a flipped crc and one with a damaged block must raise
  7. encode kernel  the CUDA block encoder against its plain torch version
              on one batch on the card, for min_profit 2, 1, 0 and 3: 128
              corpus blocks, sentinel (ff) rows, RLE rows, lengths 0-3, a
              match into the zero padding, random bytes, the rows of
              tools/profile_encode.chase_rows (more takes than a record
              chunk, matches of exactly 7, 8 and 9 bytes, 64 KiB runs, a
              match cut at the row's end, literals across chunks, chunks
              that end full, colliding keys),
              and rows whose blen does not fit the batch, which the kernel
              refuses
  8. write slice  the same 64 MiB corpus mix through
              compress_framed(raw, device="cuda"): the write path's main
              path, with the encoder's launch counter read just before and
              just after; the frame must decode through the port's CUDA
              decoder and the native one, and equal the frame built from the
              plain version's rows and the routed blocks' native streams;
              then the mix's device rows cut to 32 KiB (the encoder's
              narrow variant, two blocks an SM), a batch of them against the
              plain version, and the encoder's shared memory a block and
              blocks an SM at both row widths
  9. density and raw  every corpus file of the density gate encodes no
              larger than the native greedy encoder; compress(backend=
              "torch", device="cuda") of the 64 MiB stream and raw_to_frame of
              a native stream decode back
 10. r4 kernel  K3, the port of the pinned round-4 decoder, against its plain
              version on phase 3's battery (a trailing byte is corrupt to
              K3), on a 128 KiB batch of rows at the edges of its envelope
              (offset 65,536 and a 65,537-byte literal refused, 65,535 and
              65,536 taken), which K3 decodes in device memory (its variant
              for rows too wide to stage: the phase checks its shared memory
              a block at 128 KiB), and on rows whose lengths do not fit the
              batch
 11. decode A/B  K1 against K3 on the same streams, as bench.py's decode_own
              and decode_foreign stages run them: the 1024 block streams of
              phase 8's frame (own) and the 1024 scan_blocks segments of
              phase 5's native raw stream (foreign). Gates first: both
              kernels bit-exact with every row ok, K3 identical to its plain
              version, and where libsnappy is installed every 8th own stream
              decodes under it and the own streams are no larger than its
              output. Then interleaved rounds (3 own, 2 foreign) with
              utils/metrics.time_device_fn; each kernel's GB/s, the ratio
              vs_r4_same_run (K1 over K3) and the faster kernel; K3's and K1's
              shared memory a block, blocks an SM and waves beside their
              times. K3's launches are counted over this phase
 12. probes   the round-4 probe kernels P1-P6 (csrc/exp_vector_walk.cu), every
              variant against its plain version, bit for bit, at its high
              knob (P2 and P3 also on the stalled data of the reference's
              generator, P4 also on q0 and r past the arrays' ends, q0 at
              INT_MAX - 1 and INT_MAX among them, where the serial drain's
              q0 + 1 and q0 + 2 wrap in int32 as the reference's do), or at
              a small knob for P1 and P5, whose plain
              versions step through every iteration; then, with the launch
              counters read just before and just after,
              tools/exp_vector_walk.run times each at the script's two
              knobs: ns and cycles a step by the slope, one line a variant
              and a {"probes": [...]} line; last the one-block L2 read
              (tools/exp_vector_walk.l2_rate, which ports no TPU kernel),
              held exactly against its plain version at 1 MiB and 4 MiB,
              and its bytes a cycle, which bound a one-block drain
 13. stream   the reference's large config (bench.py's stream_large stage):
              676,000,000 bytes of the corpus mix through compress_stream and
              uncompress_stream on io.BytesIO, 128 blocks a frame, on the
              default device, after one warm-up frame; the launch counters are
              read just before each and just after: the encoder once
              per frame with a block left on the card, the decoder once per
              frame. Gates: the round trip is bit-exact, the frame count, the
              first, a middle and the last (short) frame equal to
              compress_framed of their chunk, no retry; the decode once more
              into a sink that keeps every part it is given (a memoryview of
              the pinned memory a frame came back in), the parts joined at
              the end equal to the input. The overlap gate:
              frames 0 and 1 dispatched with a SLEEP_MS torch.cuda._sleep
              queued between them; assemble_uncompress and assemble_compress
              of frame 0 must each return while an event recorded after the
              sleep is still pending (each waits for its own frame's event
              only). Then tools/profile_stream.profile: the pipeline and the
              same frames coded one at a time through compress_framed and
              uncompress_framed, in turns, with the host's time by stage (a
              line a run; GB/s of each, a {"stream": [...]} line of
              bench.py's stage record); an encoded frame's results back
              whole against lengths first (profile_stream.fetch_choice); the
              card's busy share of one stream decode from a profile_to
              trace (profile_stream.busy_share); then, on
              files in a temporary directory at 64 MiB, compress_file cut at
              25/60/97% (and one with junk after it) and resume_compress_file
              back to the same bytes, an output cut and resume_uncompress_file,
              and one `python -m snappy_tpu_torch decompress` subprocess with no
              --device
 14. mesh     the mesh and multi-host drivers on the 64 MiB corpus mix:
              compress_framed and uncompress_framed with mesh= of 1, 3 and 4
              shards, all on cuda:0, the launch counters read just before each
              call and just after (K2 and K1 once a shard, neither in the
              other's call); the frames identical for every shard count, no
              block routed, the output bit-exact; K2 and K1 against their
              plain versions on the rows only the mesh path gives them (the
              blocks routing sends to the host on the single-device path, and
              the 3-shard mesh's padding rows: blen 0, clen = ulen = 0);
              gather=True equal to gather=False for the encode and the decode;
              one launch of 1024 blocks against four of 256 (device time);
              two ranks of tools/multihost_run on the one card over gloo, a
              64 MiB file: the frame equal to the mesh frame, the output
              bit-exact, K2 and K1 once a rank, both exit 0; then
              tools/dryrun_multichip at 4 shards. Wall times on the host
              clock beside the card's name and power limit
 15. array encoder  encoder="array" (ops/encode_array.py, the JAX
              package's off-TPU parse in torch) on the 64 MiB corpus mix:
              compress_framed routes as phase 8 (51 blocks to the host, 973
              to one call of the array encoder, K2 not launched), the frame
              decodes through K1 and natively and is the rows of a direct
              call beside the routed blocks' native streams; the mix's first
              37 blocks (every corpus file) identical on the card and the
              CPU; where libsnappy is installed every 8th stream decodes
              under it and the rows are no larger than its output; raw
              compress of a 4 MiB slice identical on the card and the CPU,
              and its frames over meshes of 1 and 4 shards identical. Then
              the array encoder beside K2 on the same 973 rows (CUDA events,
              median of 5), one call by stage (candidates, extension, the
              two parses, emission; the extension's chain links, doubling
              and end-lane loop with its rounds: tools/profile_array.split),
              whole compress_framed calls with each
              encoder (host clock, min of 3), the rows', frames' and native
              frame's bytes, max_memory_allocated and the phase's seconds,
              and a {"array_encoder": {...}} line of them
 16. bench    python -m snappy_tpu_torch.tools.bench at its defaults in a
              subprocess (BENCH_* unset): its headline line's keys, every
              stage of the card's branch present, the libsnappy gates run or
              said to be skipped (libsnappy not installed), 3 rounds of each
              kernel in decode_own and 2 in decode_foreign, the scaling
              model over 4 shards of one card, K1, K2 and K3 launched; a line
              a stage with its GB/s and spread, K3's best round beside K1's
              on the bench's batch with their blocks an SM, and a
              {"bench": {...}} line of its records; then tools/run_corpus.run
              once (a line a file and the markdown table, every file's K2 and
              array streams decoded bit-exact by K1); then torch.profiler through
              utils/profiling.profile_to around one uncompress_framed of
              phase 8's frame: one trace file naming K1's annotation
              (framed.dispatch_uncompress), with its kernel events counted
 17. streams  the batched raw-stream decoder (distributed.decompress_streams)
              on one row group of the benchmark's parquet_lineitem (made on
              the card by perfbench/data/parquet_lineitem.py) and, after it
              at odd offsets, native streams of corpus files and streams at
              the segmenter's edges (a merge, a literal across the mark, a
              whole long literal, a cut stream): K4 (csrc/segment_streams.cu)
              equal to native.scan_blocks stream for stream (its rows, or
              one whole row, or not ok), its counts; K1's ragged variant
              equal to the fixed-width K1 on the same rows packed, row for
              row (bytes, ok, total); the whole call equal to the plain
              reference (cpu/streams_reference.py, each stream alone on the
              card) page for page, and to the generator's pages, with one
              launch of K4 and one of the ragged K1; K4's and the ragged
              K1's device times on the row group beside their bounds (K4's
              with every stream byte read, and with the tags alone), K4's
              slices of long streams on it (charted, and the shares the join
              met on their charts and walked tag by tag), and K4's beside
              its plain version's on 64 streams

Before the last line it prints the card's `nvidia-smi` name and power limit
and one JSON line {"kernels": [...]} with each kernel's launches on its main
path, its launches on phase 13's stream path (K1 and K2: "stream_launches"),
on phase 14's 4-shard mesh and two ranks ("mesh_launches",
"multihost_launches", the ranks' sum) and over phase 16 (K1, K2 and K3:
"bench_launches", the bench's own count and run_corpus's and the
profiled call's), K4's ("segment_streams": phase 17's decompress_streams
call, with the ragged K1's as "ragged_k1_launches"),
its largest difference from the plain version, its time beside the
plain version's at the main path's shape, and its bound: the larger of the
bytes it must move (inputs read once, outputs written once, as this run's
data needs them) over the H100's 3.35 TB/s and its operations (one integer
operation per byte read or written for the codecs; for a probe, its
estimated operations a step times its steps) over 67 TOP/s. A probe's entry
is that of its first variant, named in "variant", with its time at the high
knob ("knob"), and the plain version's and the kernel's at the gate knob
("plain_knob": "plain_ms", "ms_at_plain_knob"); the gate knob is the high
knob but for P1 and P5. No
PyTorch call computes a Snappy block decode or encode or a probe, so
library_ms is null. The array encoder ports no TPU kernel, so it has no
entry there: its line {"array_encoder": {...}} holds the card, the rows it
and the host took, its rows a chunk, its device time ("ms") beside K2's
("k2_ms"), its stages' ms in one call and that call's, the end-lane loop's
rounds and lane-rounds, the rows' and the
frames' bytes for each encoder (and native), the whole compress_framed
calls' seconds, max_memory_allocated and the phase's seconds. Times are
informational. The last line is {"ok": true, "device": {...}}. Without a
CUDA device it exits with code 2 and prints no result. It imports no JAX and
nothing of snappy_tpu.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = 1 << 16
ANY = object()  # a case whose result only has to agree between kernel and plain version
MAIN_BYTES = 64 << 20
# Rows of 32 KiB that phase 8 holds against the plain version.
NARROW_ROWS = 512
# The reference's large config, bench.py's stream_large stage at its full
# size (BENCH_STREAM_BYTES), in frames of bench.py's BATCH blocks.
STREAM_BYTES = 676_000_000
STREAM_BLOCKS_PER_FRAME = 128
# Phase 13's overlap gate: the sleep queued between two frames, and the
# sleep timed to find the card's cycles a millisecond.
SLEEP_MS = 50
SLEEP_PROBE_CYCLES = 20_000_000
# The H100 SXM's device memory rate, and its float32 rate outside the tensor
# cores, taken for the codec's integer operations (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# The same mix, in the same order, as bench.py's corpus stream.
CORPUS = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]
# The probe kernels: (launch count key, kernel name, the TPU kernel's body).
PROBE_KERNELS = [
    ("chain", "probe_chain", "benchmarks/exp_vector_walk.py:106"),
    ("walk8", "probe_walk8", "benchmarks/exp_vector_walk.py:167"),
    ("walk_scalar", "probe_walk_scalar", "benchmarks/exp_vector_walk.py:253"),
    ("drain", "probe_drain", "benchmarks/exp_vector_walk.py:389"),
    ("scalar_loop", "probe_scalar_loop", "benchmarks/exp_vector_walk.py:515"),
    ("when_drain", "probe_when_drain", "benchmarks/exp_vector_walk.py:597"),
]
# What phase 16 holds the bench's output to: bench.py's headline keys, and
# the stages of its TPU branch.
BENCH_HEADLINE = ["metric", "value", "unit", "vs_baseline", "vs_target", "vs_r4_same_run"]
BENCH_STAGES = [
    "ratio_device", "encode", "decode_own", "decode_own_r4control", "decode_own_autotuned", "decode_foreign",
    "decode_windowed_fallback", "large_device", "stream_large", "scaling_model",
]
# The files of the per-file density gate (tests/test_tpu_compiled.py).
DENSITY_FILES = [
    "alice29.txt", "asyoulik.txt", "html", "html_x_4", "urls.10K",
    "fireworks.jpeg", "paper-100k.pdf", "lcet10.txt", "plrabn12.txt",
    "geo.protodata", "kppkn.gtb", "sample-tweet.json", "random1.bin",
    "random2.bin", "random3.bin", "smallrandom1.bin",
]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def read(name: str) -> bytes:
    with open(os.path.join(REPO, "testdata", name), "rb") as f:
        return f.read()


def corpus_stream(target: int) -> bytes:
    bufs = [read(n) for n in CORPUS]
    out, total, i = [], 0, 0
    while total < target:
        out.append(bufs[i % len(bufs)])
        total += len(out[-1])
        i += 1
    return b"".join(out)[:target]


def block_streams(nat, raw: bytes) -> tuple[list[bytes], np.ndarray]:
    """Headerless tag streams of the 64 KiB blocks of ``raw`` (native)."""
    n = -(-len(raw) // BLOCK)
    buf = np.zeros((n, BLOCK), np.uint8)
    flat = np.frombuffer(raw, np.uint8)
    buf.reshape(-1)[: len(flat)] = flat
    blens = np.full(n, BLOCK, np.int32)
    blens[-1] = len(raw) - BLOCK * (n - 1)
    return nat.compress_rows(buf, blens, np.arange(n)), blens


def bound(in_bytes: int, out_bytes: int, ops: int | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take to
    read ``in_bytes`` and write ``out_bytes`` and do ``ops`` integer
    operations (by default one per byte)."""
    by_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = (in_bytes + out_bytes if ops is None else ops) / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_err(a, b) -> int:
    return int((a.int() - b.int()).abs().max()) if a.numel() else 0


def raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


class KeepParts:
    """A stream sink that keeps every part ``write`` is given."""

    def __init__(self):
        self.parts = []

    def write(self, b) -> int:
        self.parts.append(b)
        return len(b)


def stream_phase(card: str, name: str, raw_main: bytes) -> dict[str, int]:
    """Phase 13: the streaming pipeline at the reference's large config, on
    the default device, then resume on files. Returns the stream path's
    launches of the decoder and the encoder."""
    import snappy_tpu_torch
    from snappy_tpu_torch.ops import route
    from snappy_tpu_torch.ops.host import blockify
    from snappy_tpu_torch.parallel import streaming
    from snappy_tpu_torch.tools import profile_stream
    from snappy_tpu_torch.utils import profiling
    from snappy_tpu_torch.utils.metrics import Metrics

    bpf = STREAM_BLOCKS_PER_FRAME
    chunk = bpf * BLOCK
    raw = corpus_stream(STREAM_BYTES)
    chunks = [raw[i : i + chunk] for i in range(0, len(raw), chunk)]
    n_frames = len(chunks)
    check(len(chunks[-1]) < chunk, "the large config's last frame is not short")
    on_card = 0  # frames with a block that routing leaves on the card
    for c in chunks:
        buf, blens = blockify(np.frombuffer(c, np.uint8), BLOCK)
        on_card += len(route.host_blocks(buf, blens)) < len(blens)

    # One warm-up frame through both directions, as bench.py does.
    warm = io.BytesIO()
    streaming.compress_stream(io.BytesIO(chunks[0]), warm, blocks_per_frame=bpf)
    warm.seek(0)
    streaming.uncompress_stream(warm, io.BytesIO())

    before = profiling.counters()
    dst = io.BytesIO()
    streaming.compress_stream(io.BytesIO(raw), dst, blocks_per_frame=bpf)
    moved = profiling.since(before)
    enc_launches, dec_during_enc = moved["k2.launches"], moved["k1.launches"]
    comp = dst.getvalue()
    before = profiling.counters()
    dst = io.BytesIO()
    streaming.uncompress_stream(io.BytesIO(comp), dst)
    moved = profiling.since(before)
    dec_launches, enc_during_dec = moved["k1.launches"], moved["k2.launches"]
    stats = dict(streaming.last_stats)
    check(dst.getvalue() == raw, "the stream round trip is not bit-exact")
    del dst
    # Once more into a sink that keeps every part: each is a view of the
    # pinned memory its frame came back in, which no later frame may reuse
    # while the sink holds the view.
    kept = KeepParts()
    streaming.uncompress_stream(io.BytesIO(comp), kept)
    check(len(kept.parts) == n_frames and all(isinstance(p, memoryview) for p in kept.parts),
          f"the kept sink got {len(kept.parts)} parts of types {sorted({type(p).__name__ for p in kept.parts})}")
    check(b"".join(kept.parts) == raw, "a part the sink kept changed before the stream ended")
    del kept
    frames = list(streaming.iter_frames(io.BytesIO(comp)))
    check(len(frames) == n_frames and stats["frames"] == n_frames,
          f"{len(frames)} frames written, {stats['frames']} decoded, {n_frames} expected")
    check(stats["retries"] == 0, f"the stream decode retried: {stats}")
    check(dec_launches == n_frames and dec_during_enc == 0,
          f"decoder launches {dec_launches} for {n_frames} frames ({dec_during_enc} during the encode)")
    check(enc_launches == on_card and enc_during_dec == 0,
          f"encoder launches {enc_launches} for {on_card} frames with a block on the card "
          f"({enc_during_dec} during the decode)")
    for i in (0, n_frames // 2, n_frames - 1):
        check(frames[i] == snappy_tpu_torch.compress_framed(chunks[i]), f"frame {i} differs from compress_framed")
    print(f"[13 stream] {len(raw)} bytes of the corpus mix, {bpf} blocks a frame: {n_frames} frames "
          f"(the last {len(chunks[-1])} bytes), {len(comp)} bytes; round trip bit-exact, and the "
          f"{n_frames} memoryviews a sink kept joined equal to the input at the end; frames 0, "
          f"{n_frames // 2} and {n_frames - 1} equal compress_framed of their chunk; retries 0; decoder "
          f"launches {dec_launches} (one a frame), encoder launches {enc_launches} (the {on_card} frames "
          f"with a block on the card)", flush=True)
    overlap_check(card, chunks[:2], frames[:2])
    del frames, chunks

    # The timed turns: the pipeline and the same frames one at a time
    # (compress_framed, uncompress_framed), with the host's time by stage.
    rows = profile_stream.profile(raw, bpf, "cuda")
    for r in rows:
        print(f"[13 stream] {profile_stream.line(r)}", flush=True)
    best = {}
    for r in rows:
        key = r["direction"] + ("" if r["mode"] == "pipelined" else "_serial")
        best[key] = max(best.get(key, 0.0), r["gbps"])
    record = Metrics(run={"device": name, "card": card})
    record.add(stage="stream_large", bytes=len(raw), ratio=len(comp) / len(raw),
               compress_gbps=best["compress"], uncompress_gbps=best["uncompress"],
               compress_serial_gbps=best["compress_serial"], uncompress_serial_gbps=best["uncompress_serial"],
               blocks_per_frame=bpf, frames=n_frames, retries=stats["retries"])
    print(f"[13 stream] on {card}: ratio {len(comp) / len(raw):.4f}; pipelined compress_gbps "
          f"{best['compress']:.4f}, uncompress_gbps {best['uncompress']:.4f}; one frame at a time "
          f"compress_framed {best['compress_serial']:.4f}, uncompress_framed {best['uncompress_serial']:.4f} "
          f"GB/s (best of 2 turns each)", flush=True)
    print(json.dumps({"stream": record.results}), flush=True)
    fetch = profile_stream.fetch_choice(raw, bpf, "cuda")
    print(f"[13 stream] on {card}: an encoded frame's results back, {fetch['rows']} rows: whole rows behind an "
          f"event {fetch['whole_rows_ms']:.3f} ms ({fetch['whole_rows_bytes']} bytes), lengths first "
          f"{fetch['lengths_first_ms']:.3f} ms ({fetch['lengths_first_bytes']} bytes), medians of 5", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        busy = profile_stream.busy_share(comp, "cuda", tmp)
    print(f"[13 stream] on {card}: uncompress_stream of the {n_frames} frames under profile_to "
          f"{busy['seconds']:.4f} s, the card busy {busy['device_busy_s']:.4f} s: busy share "
          f"{busy['busy_share']:.4f} ({busy['kernels']} kernels, {busy['copies']} copies)", flush=True)
    del comp

    # Resume on files: a kill during compress, one during decompress, and the CLI.
    raw_f = raw_main[: len(raw_main) - 12345]  # the last frame short
    with tempfile.TemporaryDirectory() as tmp:
        src, full_path = os.path.join(tmp, "in.bin"), os.path.join(tmp, "full.snpf")
        with open(src, "wb") as f:
            f.write(raw_f)
        streaming.compress_file(src, full_path)
        with open(full_path, "rb") as f:
            full = f.read()
        cut_path = os.path.join(tmp, "cut.snpf")
        for label, torn in (("25%", full[: len(full) // 4]), ("60%", full[: len(full) * 6 // 10]),
                            ("97%", full[: len(full) * 97 // 100]), ("junk", full + b"\x99" * 7)):
            with open(cut_path, "wb") as f:
                f.write(torn)
            size = streaming.resume_compress_file(src, cut_path)
            with open(cut_path, "rb") as f:
                check(size == len(full) and f.read() == full, f"resume_compress_file after a cut at {label}")
        out_path = os.path.join(tmp, "out.bin")
        for cut in (0, 3 * BLOCK + 5, len(raw_f) - 3):
            with open(out_path, "wb") as f:
                f.write(raw_f[:cut])
            n = streaming.resume_uncompress_file(full_path, out_path)
            with open(out_path, "rb") as f:
                check(n == len(raw_f) and f.read() == raw_f, f"resume_uncompress_file after a cut at {cut}")
        cli_path = os.path.join(tmp, "cli.bin")
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "snappy_tpu_torch", "decompress", full_path, cli_path],
                             cwd=REPO, capture_output=True, text=True, timeout=300)
        t_cli = time.perf_counter() - t0
        check(run.returncode == 0, f"python -m snappy_tpu_torch decompress failed: {run.stderr[-2000:]}")
        with open(cli_path, "rb") as f:
            check(f.read() == raw_f, "python -m snappy_tpu_torch decompress gave other bytes")
    print(f"[13 stream] files of {len(raw_f)} bytes, {len(full)} compressed in "
          f"{-(-len(raw_f) // (streaming.DEFAULT_BLOCKS_PER_FRAME * BLOCK))} frames: resume_compress_file after "
          f"cuts at 25/60/97% and after junk gives the same bytes; resume_uncompress_file after 3 cuts; "
          f"`python -m snappy_tpu_torch decompress` (no --device) equal to the input in {t_cli:.1f} s "
          f"with the process start", flush=True)
    return {"decode_blocks": dec_launches, "encode_blocks": enc_launches}


def overlap_check(card: str, chunks: list[bytes], frames: list[bytes]) -> None:
    """Phase 13's gate on the pipeline's overlap: frames k and k+1 are
    dispatched with about SLEEP_MS of ``torch.cuda._sleep`` queued between
    them, and an event after the sleep. The assemble of frame k must return
    while that event is still pending, in both directions: it waits for its
    own frame only."""
    import torch

    from snappy_tpu_torch.parallel import host as fhost

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_PROBE_CYCLES)
    end.record()
    end.synchronize()
    cycles = int(SLEEP_PROBE_CYCLES / start.elapsed_time(end) * SLEEP_MS)
    for direction, dispatch, assemble, given, want in (
        ("uncompress", fhost.dispatch_uncompress, fhost.assemble_uncompress, frames, chunks),
        ("compress", fhost.dispatch_compress, fhost.assemble_compress, chunks, frames),
    ):
        torch.cuda.synchronize()
        first = dispatch(given[0])
        torch.cuda._sleep(cycles)
        after = torch.cuda.Event()
        after.record()
        second = dispatch(given[1])
        t0 = time.perf_counter()
        got = assemble(first)
        pending = not after.query()
        t_first = time.perf_counter() - t0
        check(got == want[0] and assemble(second) == want[1], f"assemble_{direction} gave other bytes")
        check(pending, f"assemble_{direction} of frame k waited for the {SLEEP_MS} ms sleep queued after it")
        print(f"[13 stream] on {card}: assemble_{direction} of frame k returned in {t_first * 1e3:.1f} ms while "
              f"the {SLEEP_MS} ms sleep queued after it ran on ({cycles} cycles)", flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(nprocs: int, in_path: str, frame_path: str, out_path: str, device: str) -> list[dict]:
    """Run ``nprocs`` ranks of tools/multihost_run, one card-shard each, and
    return each rank's JSON record; fails unless every rank exits 0."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "snappy_tpu_torch.tools.multihost_run", f"127.0.0.1:{port}", str(nprocs), str(r),
         in_path, frame_path, out_path, "--device", device],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(nprocs)]
    try:
        done = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, done)):
        check(p.returncode == 0, f"rank {r} of {nprocs} exited {p.returncode}: {err[-2000:]}")
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in done]


def mesh_phase(card: str, raw_main: bytes, routed_frame: bytes, dev, rank_device: str = "cuda") -> dict[str, int]:
    """Phase 14: the mesh and multi-host drivers on ``raw_main``, every shard
    on ``dev``. Returns the 4-shard mesh's launches of each kernel and the
    two ranks' launches."""
    import torch

    import snappy_tpu_torch
    from snappy_tpu_torch.native import runtime as nat
    from snappy_tpu_torch.ops import cuda_decode, cuda_encode, decode_torch, encode_torch, route
    from snappy_tpu_torch.ops.host import blockify, to_device
    from snappy_tpu_torch.parallel import distributed, framed
    from snappy_tpu_torch.parallel import host as fhost
    from snappy_tpu_torch.tools import dryrun_multichip
    from snappy_tpu_torch.utils import profiling
    from snappy_tpu_torch.utils.metrics import time_device_fn

    n_blocks = -(-len(raw_main) // BLOCK)
    gb = len(raw_main) / 1e9
    frames, calls, counts = {}, {}, {}
    for shards in (1, 3, 4):
        mesh = distributed.mesh_1d([dev] * shards)
        c_calls, u_calls = [], []
        for rep in range(3):
            before = profiling.counters()
            t0 = time.perf_counter()
            frame = snappy_tpu_torch.compress_framed(raw_main, mesh=mesh)
            c_calls.append(time.perf_counter() - t0)
            moved = profiling.since(before)
            enc, dec_in_enc = moved["k2.launches"], moved["k1.launches"]
            before = profiling.counters()
            t0 = time.perf_counter()
            out = snappy_tpu_torch.uncompress_framed(frame, mesh=mesh)
            u_calls.append(time.perf_counter() - t0)
            moved = profiling.since(before)
            dec, enc_in_dec = moved["k1.launches"], moved["k2.launches"]
            check(enc == shards and dec_in_enc == 0, f"{shards}-shard compress_framed: encoder launches {enc}, "
                  f"decoder {dec_in_enc}")
            check(dec == shards and enc_in_dec == 0, f"{shards}-shard uncompress_framed: decoder launches {dec}, "
                  f"encoder {enc_in_dec}")
            check(out == raw_main, f"{shards}-shard mesh round trip is not bit-exact")
            check(frames.setdefault(shards, frame) == frame, f"{shards}-shard mesh frame changed between calls")
        calls[shards] = (c_calls, u_calls)
        counts[shards] = (enc, dec)
    frame = frames[1]
    check(frames[3] == frame and frames[4] == frame, "the mesh frame depends on the shard count")
    check(nat.uncompress(framed.frame_to_raw(frame)) == raw_main, "the mesh frame does not decode natively")
    check(snappy_tpu_torch.uncompress_framed(frame, device=dev) == raw_main,
          "the mesh frame does not decode through uncompress_framed without a mesh")
    idx = framed.parse_index(frame)
    print(f"[14 mesh] {len(raw_main) / 2**20:g} MiB corpus mix, {n_blocks} blocks: meshes of 1, 3 and 4 shards on {dev} write one frame "
          f"({len(frame)} bytes; the routed frame of phase 8 is {len(routed_frame)} bytes, "
          f"{'equal' if frame == routed_frame else 'different'}), decoded bit-exact by each mesh, without a mesh "
          f"and natively; launches (encode, decode) per call {counts}", flush=True)
    for shards, (c_calls, u_calls) in calls.items():
        print(f"[14 mesh] on {card}: {shards}-shard compress_framed min {min(c_calls):.4f} s "
              f"({gb / min(c_calls):.3f} GB/s) of {[round(c, 4) for c in c_calls]}, uncompress_framed min "
              f"{min(u_calls):.4f} s ({gb / min(u_calls):.3f} GB/s) of {[round(c, 4) for c in u_calls]}", flush=True)

    # The rows only the mesh path gives the kernels: the blocks that routing
    # sends to the host, and the 3-shard mesh's padding rows.
    nb3 = distributed.pad_block_count(n_blocks, 3)
    buf, blens = blockify(np.frombuffer(raw_main, np.uint8), BLOCK, nb3)
    host_idx = route.host_blocks(buf[:n_blocks], blens[:n_blocks])
    rows = np.concatenate([host_idx, np.arange(n_blocks, nb3)])
    e_args = (to_device(buf[rows], dev), to_device(blens[rows], dev), 2)
    k_out, k_olens = cuda_encode.encode_blocks(*e_args)
    p_out, p_olens = encode_torch.encode_blocks(*e_args)
    err_e = max_err(k_out, p_out)
    check(err_e == 0 and torch.equal(k_out, p_out) and torch.equal(k_olens, p_olens),
          "the encode kernel and its plain version differ on the mesh's rows")
    pad = len(rows) - len(host_idx)
    check(k_olens[len(host_idx):].tolist() == [0] * pad and not bool(k_out[len(host_idx):].any()),
          "the encode kernel wrote to a padding row")
    span = np.frombuffer(b"".join(frame[s:e] for s, e in (idx.block_ranges()[i] for i in host_idx)), np.uint8)
    d_clens = idx.comp_lens[host_idx].astype(np.int64)
    d_ulens = np.array([idx.block_ulen(int(i)) for i in host_idx], np.int64)
    d_args = (*fhost.block_batch(span, d_clens, d_ulens, BLOCK, len(rows), dev), BLOCK)
    k_out, k_ok, k_total = cuda_decode.decode_blocks(*d_args)
    p_out, p_ok, p_total = decode_torch.decode_blocks(*d_args)
    err_d = max_err(k_out, p_out)
    check(err_d == 0 and torch.equal(k_out, p_out) and torch.equal(k_ok, p_ok) and bool(k_ok.all())
          and torch.equal(k_total, p_total), "the decode kernel and its plain version differ on the mesh's rows")
    check(k_total[len(host_idx):].tolist() == [0] * pad and not bool(k_out[len(host_idx):].any()),
          "the decode kernel wrote to a padding row")
    for j, i in enumerate(host_idx.tolist()):
        check(k_out[j, : d_ulens[j]].cpu().numpy().tobytes() == raw_main[i * BLOCK : (i + 1) * BLOCK],
              f"block {i} decoded wrong")
    print(f"[14 mesh] {len(host_idx)} blocks that routing sends to the host and {pad} padding rows: K2 and K1 "
          f"identical to their plain versions (max |kernel - plain| = {max(err_e, err_d)}); padding rows olen 0, "
          f"ok with total 0, all zero", flush=True)

    # gather=True against gather=False, and one launch against four.
    mesh4 = distributed.mesh_1d([dev] * 4)
    g = distributed.compress_blocks(buf[:n_blocks], blens[:n_blocks], mesh4, gather=True)
    s = distributed.compress_blocks(buf[:n_blocks], blens[:n_blocks], mesh4)
    check(all(torch.equal(t, torch.cat(parts)) for got, parts in zip(g, s) for t in got),
          "gathered encode differs from its shards")
    whole = fhost.frame_batch(frame, idx, device=dev)
    g = distributed.decompress_blocks(*whole[:3], mesh4, whole[3], gather=True)
    s = distributed.decompress_blocks(*whole[:3], mesh4, whole[3])
    check(all(torch.equal(t, torch.cat(parts)) for got, parts in zip(g, s) for t in got),
          "gathered decode differs from its shards")
    check(bool(g[1][0].all()) and g[0][0].cpu().numpy().tobytes() == raw_main, "gathered decode is not bit-exact")
    del g, s
    out_size = whole[3]
    quarters = [tuple(a[k * n_blocks // 4 : (k + 1) * n_blocks // 4] for a in whole[:3]) + (out_size,)
                for k in range(4)]
    dec_one = time_device_fn(cuda_decode.decode_blocks, whole, iters=10) * 1e3
    dec_four = time_device_fn(lambda *_: [cuda_decode.decode_blocks(*q) for q in quarters], whole[:1], iters=10) * 1e3
    e_whole = (to_device(buf[:n_blocks], dev), to_device(blens[:n_blocks], dev), 2)
    e_quarters = [tuple(a[k * n_blocks // 4 : (k + 1) * n_blocks // 4] for a in e_whole[:2]) + (2,)
                  for k in range(4)]
    enc_one = time_device_fn(cuda_encode.encode_blocks, e_whole, iters=10) * 1e3
    enc_four = time_device_fn(lambda *_: [cuda_encode.encode_blocks(*q) for q in e_quarters], e_whole[:1],
                              iters=10) * 1e3
    print(f"[14 mesh] gather=True equals gather=False for the encode and the decode; on {card}, device time "
          f"(median of 10): K2 one launch of {n_blocks} blocks {enc_one:.4f} ms, four of {n_blocks // 4} "
          f"{enc_four:.4f} ms; K1 one launch {dec_one:.4f} ms, four {dec_four:.4f} ms", flush=True)

    # Two ranks on the one card, over gloo.
    with tempfile.TemporaryDirectory() as tmp:
        in_path, frame_path, out_path = (os.path.join(tmp, f) for f in ("in.bin", "mh.frame", "mh.out"))
        with open(in_path, "wb") as f:
            f.write(raw_main)
        t0 = time.perf_counter()
        recs = run_ranks(2, in_path, frame_path, out_path, rank_device)
        t_ranks = time.perf_counter() - t0
        with open(frame_path, "rb") as f:
            check(f.read() == frame, "the two ranks' frame differs from the mesh frame")
        with open(out_path, "rb") as f:
            check(f.read() == raw_main, "the two ranks' output is not bit-exact")
    for r in recs:
        check(r["mesh"] == 2 and r["frame_bytes"] == len(frame) and r["bytes"] == len(raw_main),
              f"rank record {r}")
        check(rank_device != "cuda" or r["launches"] == {"encode_blocks": 1, "decode_blocks": 1},
              f"rank {r['rank']} launches {r['launches']}")
    print(f"[14 mesh] two ranks of tools/multihost_run on {card} over gloo, {len(raw_main) / 2**20:g} MiB file: frame equal to the mesh "
          f"frame, output bit-exact, both exit 0; " + "; ".join(
              f"rank {r['rank']} on {r['device']}: set-up {r.get('setup_s', 0.0):.4f} s, compress_framed "
              f"{r['compress_s']:.4f} s, uncompress_framed {r['uncompress_s']:.4f} s, launches {r['launches']}"
              for r in recs)
          + f"; {t_ranks:.1f} s with the processes' start", flush=True)
    t0 = time.perf_counter()
    dryrun_multichip.dryrun_multichip(4, rank_device)  # prints its line
    print(f"[14 mesh] dryrun_multichip(4) passed in {time.perf_counter() - t0:.2f} s on {card}", flush=True)
    return {
        "encode_blocks": counts[4][0],
        "decode_blocks": counts[4][1],
        "multihost_encode_blocks": sum(r["launches"]["encode_blocks"] for r in recs),
        "multihost_decode_blocks": sum(r["launches"]["decode_blocks"] for r in recs),
    }


def array_phase(card: str, raw_main: bytes, kernel_frame: bytes, dev) -> dict:
    """Phase 15: the array encoder (``encoder="array"``, ops/encode_array.py)
    on ``raw_main`` on ``dev``: gates, then its times beside K2's on the
    same rows. Returns the {"array_encoder": ...} record."""
    import torch

    import snappy_tpu_torch
    from snappy_tpu_torch.core import varint
    from snappy_tpu_torch.native import libsnappy
    from snappy_tpu_torch.native import runtime as nat
    from snappy_tpu_torch.ops import cuda_encode, encode_array, route
    from snappy_tpu_torch.ops.host import blockify, to_device
    from snappy_tpu_torch.parallel import distributed, framed
    from snappy_tpu_torch.tools import profile_array
    from snappy_tpu_torch.utils import profiling
    from snappy_tpu_torch.utils.metrics import time_device_fn

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    buf, blens = blockify(np.frombuffer(raw_main, np.uint8), BLOCK)
    host_idx = route.host_blocks(buf, blens)
    dev_idx = np.setdiff1d(np.arange(len(blens)), host_idx)

    # The write path with encoder="array": routed as with K2, the array
    # encoder's calls recorded, K2 not launched.
    calls = []
    encode = encode_array.encode_blocks

    def recorded(blocks, lens, min_profit=None):
        calls.append((blocks.shape[0], blocks.device.type))
        return encode(blocks, lens, min_profit)

    encode_array.encode_blocks = recorded
    before = profiling.counters()
    try:
        frame = snappy_tpu_torch.compress_framed(raw_main, device=dev, encoder="array")
    finally:
        encode_array.encode_blocks = encode
    k2 = profiling.since(before)["k2.launches"]
    check(k2 == 0, f"encoder='array' launched K2 {k2} times")
    check(calls == [(len(dev_idx), dev.type)], f"the array encoder's calls {calls}, expected one of "
          f"{len(dev_idx)} rows on {dev.type}")
    check(snappy_tpu_torch.uncompress_framed(frame, device=dev) == raw_main,
          "the array encoder's frame does not decode through uncompress_framed")
    check(nat.uncompress(framed.frame_to_raw(frame)) == raw_main, "the array encoder's frame does not decode natively")

    # The card's rows against the CPU's: the whole first pass of the mix,
    # every corpus file in it.
    d_blocks, d_blens = to_device(buf[dev_idx], dev), to_device(blens[dev_idx], dev)
    out, olens = encode_array.encode_blocks(d_blocks, d_blens)
    out_np, olens_np = out.cpu().numpy(), olens.cpu().numpy()
    streams = nat.compress_rows(buf, blens, np.arange(len(blens)))
    for j, i in enumerate(dev_idx.tolist()):
        streams[i] = out_np[j, : olens_np[j]].tobytes()
    raws = [raw_main[i * BLOCK : (i + 1) * BLOCK] for i in range(len(blens))]
    check(framed.build_frame(streams, raws, len(raw_main)) == frame,
          "the array frame is not the card's rows and the routed blocks' native streams")
    first = -(-sum(len(read(n)) for n in CORPUS) // BLOCK)
    c_out, c_olens = encode_array.encode_blocks(to_device(buf[:first], dev), to_device(blens[:first], dev))
    p_out, p_olens = encode_array.encode_blocks(torch.from_numpy(buf[:first]), torch.from_numpy(blens[:first]))
    check(torch.equal(c_olens.cpu(), p_olens) and torch.equal(c_out.cpu(), p_out),
          f"the card's rows differ from the CPU's on the first {first} blocks")
    gate = "libsnappy not installed: its gate did not run"
    dev_bytes = int(olens_np.sum())
    if libsnappy.available():
        hdr = bytes(varint.encode32(BLOCK))
        for j in range(0, len(dev_idx), 8):
            i = int(dev_idx[j])
            check(libsnappy.uncompress(bytes(varint.encode32(int(blens[i]))) + streams[i]) == raws[i],
                  f"array stream {i} does not decode under libsnappy")
        ls = sum(len(libsnappy.compress(raws[i])) - len(hdr) for i in dev_idx.tolist())
        check(dev_bytes <= ls, f"the array encoder's rows {dev_bytes} bytes > libsnappy {ls}")
        gate = f"libsnappy gate ran: every 8th device stream decodes under it; {dev_bytes} bytes <= libsnappy {ls}"

    # Raw streams of a 4 MiB slice, on the card and the CPU, and its frames
    # over meshes of 1 and 4 shards.
    part = raw_main[: 4 << 20]
    raw_c = snappy_tpu_torch.compress(part, backend="torch", device=dev, encoder="array")
    check(raw_c == snappy_tpu_torch.compress(part, backend="torch", device="cpu", encoder="array"),
          "raw compress(encoder='array') differs between the card and the CPU")
    check(nat.uncompress(raw_c) == part, "raw compress(encoder='array') does not decode")
    mesh_frames = [snappy_tpu_torch.compress_framed(part, mesh=distributed.mesh_1d([dev] * k), encoder="array")
                   for k in (1, 4)]
    check(mesh_frames[0] == mesh_frames[1], "the array encoder's 4-shard frame differs from its 1-shard frame")
    check(snappy_tpu_torch.uncompress_framed(mesh_frames[1], device=dev) == part, "the mesh frame does not decode")
    print(f"[15 array encoder] compress_framed(encoder='array') of the {len(raw_main) / 2**20:g} MiB mix: "
          f"{len(host_idx)} blocks routed to the host, {len(dev_idx)} to the array encoder in one call on {dev.type}, "
          f"K2 not launched; the frame decodes (K1, native) and is the rows of a direct call; the first {first} "
          f"blocks (every corpus file) identical on the card and the CPU; {gate}; raw compress of 4 MiB "
          f"identical on the card and the CPU and decodes; 4-shard mesh frame equals the 1-shard frame", flush=True)

    # Times: the array encoder and K2 on the same rows, the array encoder's
    # stages in one call, whole framed calls with each encoder.
    args = (d_blocks, d_blens, 2)
    array_ms = time_device_fn(encode_array.encode_blocks, args, iters=5, warmup=1) * 1e3
    k2_ms = time_device_fn(cuda_encode.encode_blocks, args, iters=5, warmup=1) * 1e3
    k2_bytes = int(cuda_encode.encode_blocks(*args)[1].sum())
    split = profile_array.split(d_blocks, d_blens)
    stage_ms = split["stage_ms"]
    stage_ms["rest"] = split["call_ms"] - sum(stage_ms[k] for k in ("candidates", "extension", "parse", "emission"))
    framed_s = {}
    for enc in ("array", "kernel"):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = snappy_tpu_torch.compress_framed(raw_main, device=dev, encoder=enc)
            runs.append(time.perf_counter() - t0)
            check(again == (frame if enc == "array" else kernel_frame), f"repeat compress_framed({enc}) changed")
        framed_s[enc] = runs
    native_frame = len(framed.build_frame(nat.compress_rows(buf, blens, np.arange(len(blens))), raws, len(raw_main)))
    peak = torch.cuda.max_memory_allocated(dev)
    chunk = encode_array.rows_per_chunk(buf.shape[1], dev)
    record = {
        "card": card,
        "rows": len(dev_idx),
        "host_rows": len(host_idx),
        "rows_a_chunk": chunk,
        "ms": array_ms,
        "k2_ms": k2_ms,
        "stage_ms": stage_ms,
        "stage_call_ms": split["call_ms"],
        "end_loop_rounds": split["rounds"],
        "end_loop_lane_rounds": sum(split["live_lanes"]),
        "rows_bytes": {"array": dev_bytes, "kernel": k2_bytes},
        "frame_bytes": {"array": len(frame), "kernel": len(kernel_frame), "native": native_frame},
        "compress_framed_s": framed_s,
        "max_memory_allocated": peak,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"[15 array encoder] on {card}: {len(dev_idx)} rows ({chunk} a chunk): array encoder {array_ms:.4f} ms, "
          f"K2 {k2_ms:.4f} ms (device time, median of 5); one call by stage (ms; links, doubling and end_loop are "
          f"steps of the extension) { {k: round(v, 4) for k, v in stage_ms.items()} } of {split['call_ms']:.4f}, "
          f"the end-lane loop {split['rounds']} rounds and {sum(split['live_lanes'])} lane-rounds; rows {dev_bytes} "
          f"bytes against K2's "
          f"{k2_bytes}; frames: array {len(frame)}, K2 {len(kernel_frame)}, native {native_frame} bytes; whole "
          f"compress_framed min array {min(framed_s['array']):.4f} s, K2 {min(framed_s['kernel']):.4f} s; "
          f"max_memory_allocated {peak / 2**30:.3f} GiB; phase {record['phase_s']:.1f} s", flush=True)
    return record


def bench_phase(card: str, raw_main: bytes, frame: bytes, dev) -> dict[str, int]:
    """Phase 16: the port's bench at its defaults in a subprocess, the
    per-file corpus table once, and a profiler trace of one
    uncompress_framed of ``frame`` (``raw_main``'s). Returns K1's, K2's and
    K3's launches over the phase."""
    import torch

    import snappy_tpu_torch
    from snappy_tpu_torch.ops import cuda_decode, cuda_decode_r4
    from snappy_tpu_torch.tools import bench, run_corpus
    from snappy_tpu_torch.utils import profile_to

    modules = bench.KERNEL_COUNTERS
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.tools.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    t_bench = time.perf_counter() - t0
    check(run.returncode == 0, f"the bench exited {run.returncode}: {run.stderr[-3000:]}")
    out = run.stdout.strip().splitlines()
    report, headline = json.loads(out[-2]), json.loads(out[-1])
    check(all(k in headline for k in BENCH_HEADLINE) and headline["metric"] == "device_decompress_throughput"
          and headline["unit"] == "GB/s/chip", f"the bench's headline {headline}")
    recs = {r["stage"]: r for r in report["stages"]}
    check(all(k in recs for k in BENCH_STAGES), f"the bench's stages {list(recs)}")
    gates = recs["ratio_device"]["libsnappy_gates"]
    check(gates == "ran" or (gates == "skipped: libsnappy not installed" and "ratio_libsnappy" not in recs),
          f"the bench's libsnappy gates: {gates}")
    check([len(v) for v in recs["decode_own"]["rounds_ms"].values()] == [3, 3]
          and [len(v) for v in recs["decode_foreign"]["rounds_ms"].values()] == [2, 2],
          "the bench's decode rounds did not all run")
    check(recs["scaling_model"]["shards"] == "4 of one card", f"scaling shards {recs['scaling_model']['shards']}")
    bench_launches = report["run"]["launches"]
    check(all(bench_launches[k] > 0 for k in modules), f"the bench's launches {bench_launches}")
    print(f"[16 bench] python -m snappy_tpu_torch.tools.bench at its defaults on {report['run']['card']}: "
          f"{t_bench:.1f} s with the process's start; libsnappy gates {gates}; launches {bench_launches}; "
          f"headline {json.dumps(headline)}", flush=True)
    for r in report["stages"]:
        rates = {k: v for k, v in r.items() if "gbps" in k or k in ("compressed_ratio", "ratio", "collective_share")}
        spread = r["timing"]["spread"] if "timing" in r else None
        print(f"[16 bench] {r['stage']}: {rates}" + (f", spread {spread:.4f}" if spread is not None else ""),
              flush=True)
    own = recs["decode_own"]["rounds_ms"]
    k3_smem, k3_per_sm = cuda_decode_r4.occupancy(bench.B)
    k1_smem, k1_per_sm = cuda_decode.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[16 bench] decode_own on {card}: K3 {min(own['r4_grouped']):.4f} ms ({k3_per_sm} blocks an SM, "
          f"{k3_per_sm * sms} at once) beside K1 {min(own['r5_farnear']):.4f} ms ({k1_per_sm} an SM, {k1_per_sm * sms} "
          f"at once), best of {len(own['r4_grouped'])} rounds; vs_r4_same_run "
          f"{recs['decode_own_r4control']['vs_r4_same_run']:.4f}; decode_own_autotuned picks "
          f"{recs['decode_own_autotuned']['picked']}", flush=True)
    print(json.dumps({"bench": {"run": report["run"], "stages": report["stages"], "headline": headline}}), flush=True)

    before = bench.launches()
    t0 = time.perf_counter()
    rows = run_corpus.run(dev, iters=3)
    print(run_corpus.table(rows), flush=True)
    print(f"[16 bench] tools/run_corpus.run on {card}: {len(rows)} files, each file's K2 and array streams "
          f"decoded bit-exact by K1; {time.perf_counter() - t0:.1f} s", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        with profile_to(tmp):
            got = snappy_tpu_torch.uncompress_framed(frame, device=dev)
        check(got == raw_main, "the profiled uncompress_framed is not bit-exact")
        traces = os.listdir(tmp)
        check(len(traces) == 1, f"profile_to wrote {traces}")
        with open(os.path.join(tmp, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name") for e in events}
        check("framed.dispatch_uncompress" in names, "the trace does not name K1's annotation")
        kernel_events = [e for e in events if e.get("cat") == "kernel"]
        k1_us = sum(e.get("dur", 0) for e in kernel_events if "decode_blocks_kernel" in e.get("name", ""))
        print(f"[16 bench] profile_to around one uncompress_framed of the {len(raw_main) / 2**20:g} MiB frame: "
              f"{traces[0]} ({os.path.getsize(os.path.join(tmp, traces[0]))} bytes, {len(events)} events) names "
              f"framed.dispatch_uncompress; {len(kernel_events)} kernel events, K1's {k1_us} us", flush=True)
    after = bench.launches()
    return {k: bench_launches[k] + after[k] - before[k] for k in modules}


def edge_streams() -> list[tuple[bytes, int]]:
    """(stream, stated length) at the segmenter's edges: a copy that merges
    two segments, a literal across the 64 KiB mark, a 200,000-byte literal
    (taken whole), a cut stream (not ok)."""
    from snappy_tpu_torch.core import varint

    def literal(data: bytes) -> bytes:
        return bytes([62 << 2]) + (len(data) - 1).to_bytes(3, "little") + data

    rng = np.random.default_rng(17)
    noise = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    merged = noise[:BLOCK] + noise[BLOCK - 100 : BLOCK - 96]
    across = b"".join(literal(noise[a:b]) for a, b in ((0, 2000), (2000, 67000), (67000, 131072)))
    cut = varint.encode32(100_000) + literal(noise[:100_000])[:50_000]
    return [(varint.encode32(len(merged)) + literal(noise[:BLOCK]) + bytes([0x01, 100]), len(merged)),
            (varint.encode32(131072) + across, 131072), (varint.encode32(200_000) + literal(noise), 200_000),
            (cut, 100_000)]


def literal_payload(comp, starts, clens, ulens) -> int:
    """The literals' payload bytes of the raw streams in ``comp`` (uint8 on
    the card; stream i the ``clens[i]`` bytes at ``starts[i]``, stated to
    decode to ``ulens[i]``; numpy), by pointer jumping over every byte's
    next tag: what a walk of the tags alone does not read."""
    import torch

    dev = comp.device
    n = comp.numel()
    pos = torch.arange(n, device=dev)
    st = torch.from_numpy(starts).to(dev)
    ends = st + torch.from_numpy(clens.astype(np.int64)).to(dev)
    owner = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    owner.index_add_(0, st, torch.ones_like(st))
    owner = torch.cumsum(owner, 0)[:n] - 1
    stream_end = torch.where(owner >= 0, ends[owner.clamp(min=0)], 0)
    inside = pos < stream_end
    b = comp.long()
    short = b >> 2
    extra = (short - 59).clamp(min=0, max=4)
    lit = sum(torch.where(extra > k, b[(pos + 1 + k).clamp(max=n - 1)] << (8 * k), 0) for k in range(4))
    lit = torch.where(short < 60, short, lit) + 1
    is_lit = (b & 3) == 0
    size = torch.where(is_lit, 1 + extra + lit, torch.tensor([0, 2, 3, 5], device=dev)[b & 3])
    del short, extra, b
    sink = torch.full((1,), n, device=dev)
    nxt = torch.cat([torch.where(inside & (pos + size < stream_end), pos + size, n), sink])
    weight = torch.cat([torch.where(inside & is_lit & (pos + size <= stream_end), lit, 0), sink * 0])
    del pos, size, lit, is_lit, inside, stream_end, owner
    while bool((nxt[:n] < n).any()):
        weight = weight + weight[nxt]
        nxt = nxt[nxt]
    u = torch.from_numpy(ulens.astype(np.int64)).to(dev)
    heads = st + 1 + sum((u >= 1 << (7 * k)).long() for k in range(1, 5))
    return int(weight[heads].sum())


def streams_phase(card: str, dev) -> dict:
    """Phase 17: the batched raw-stream decoder on a row group of
    parquet_lineitem and odd streams after it. Returns K4's entry of the
    kernels line."""
    import torch

    from perfbench.data import parquet_lineitem
    from perfbench.registry import Registry
    from snappy_tpu_torch import CorruptInputError
    from snappy_tpu_torch.cpu import streams_reference
    from snappy_tpu_torch.native import runtime as nat
    from snappy_tpu_torch.ops import cuda_decode, cuda_segment
    from snappy_tpu_torch.ops.host import pack_rows
    from snappy_tpu_torch.parallel import distributed
    from snappy_tpu_torch.utils import profiling
    from snappy_tpu_torch.utils.metrics import time_device_fn

    t0 = time.perf_counter()
    config = Registry().config("parquet_lineitem")
    groups = parquet_lineitem.row_groups(config, dev)
    group = groups[0]
    t_gen = time.perf_counter() - t0
    # The row group, then the odd streams, each after a gap of 0 to 40 bytes.
    rng = np.random.default_rng(171)
    extra = [(nat.compress(read(n)), len(read(n))) for n in ("alice29.txt", "html", "fireworks.jpeg")]
    extra += edge_streams()
    data, starts = bytearray(group.data.tobytes()), list(group.starts.tolist())
    clens, ulens = list(group.clens.tolist()), list(group.ulens.tolist())
    out_starts, out_len = list(group.out_starts.tolist()), group.out_len
    for stream, stated in extra:
        data += rng.integers(0, 256, int(rng.integers(0, 41)), dtype=np.uint8).tobytes()
        starts.append(len(data))
        data += stream
        clens.append(len(stream))
        ulens.append(stated)
        out_len += int(rng.integers(0, 24))
        out_starts.append(out_len)
        out_len += stated
    host = np.frombuffer(bytes(data), np.uint8)
    args = (torch.from_numpy(host.copy()).to(dev), torch.tensor(starts, device=dev),
            torch.tensor(clens, dtype=torch.int32, device=dev), torch.tensor(ulens, dtype=torch.int32, device=dev),
            torch.tensor(out_starts, device=dev), out_len)
    n = len(starts)
    pages = len(group.starts)

    def against_scan(host, starts, clens, ulens, out_starts, out_len):
        """K4 on the streams against the native scan, stream for stream:
        (rows, ok, stats) as numpy arrays, rows past the reservation cut."""
        n = len(starts)
        capacity = cuda_segment.capacity_for(n, out_len)  # the table segment_streams takes
        args = (torch.from_numpy(host.copy()).to(dev), torch.tensor(starts, device=dev),
                torch.tensor(clens, dtype=torch.int32, device=dev), torch.tensor(ulens, dtype=torch.int32, device=dev),
                torch.tensor(out_starts, device=dev), out_len)
        before = profiling.counters()
        rows, ok, stats = cuda_segment.segment_streams(*args)
        torch.cuda.synchronize()
        launched = profiling.since(before)["k4.launches"]
        check(launched == 1, f"K4 launched {launched} times for one call")
        ok, stats = ok.cpu().numpy().astype(bool), stats.cpu().numpy()
        used = int(stats[0])
        cols = [r[:used].cpu().numpy() for r in rows]
        ins, outs, cls, uls, sts = cols
        by_stream = {}
        for i in np.flatnonzero(cls > 0):
            by_stream.setdefault(int(sts[i]), []).append(i)
        want_rows = want_whole = 0
        for s in range(n):
            stream = host[starts[s] : starts[s] + clens[s]]
            try:
                ulen, h = nat.uncompressed_length(stream.tobytes())
                scan = nat.scan_blocks(stream[h:], ulen) if ulen == ulens[s] else False
            except CorruptInputError:
                scan = False
            got = sorted(by_stream.get(s, []), key=lambda i: ins[i])
            if scan is False:
                check(not ok[s] and not got, f"stream {s}: K4 kept a stream the native scan calls corrupt")
                continue
            check(ok[s], f"stream {s}: K4 refused a stream the native scan takes")
            body = starts[s] + h
            if scan is None:
                want_whole += 1
                check([(ins[i], cls[i], uls[i], outs[i]) for i in got] == [(body, clens[s] - h, ulen, out_starts[s])],
                      f"stream {s}: not one whole row")
            else:
                seg_starts, oplens = scan
                check([int(ins[i]) - body for i in got] == seg_starts.tolist()
                      and [int(uls[i]) for i in got] == oplens.tolist()
                      and [int(outs[i]) - out_starts[s] for i in got] == (np.cumsum(oplens) - oplens).tolist(),
                      f"stream {s}: K4's segments differ from the native scan's")
            want_rows += len(got)
        check(int(stats[1]) == int((cls > 0).sum()) == want_rows and int(stats[3]) == want_whole,
              f"K4's counts {stats.tolist()} against {want_rows} rows, {want_whole} whole")
        return rows, ok, stats, cols, capacity

    # K4 against the native scan, stream for stream: the first row group with
    # the odd streams after it, then the other resident row groups alone.
    rows, ok, stats, (ins, outs, cls, uls, sts), capacity = against_scan(host, starts, clens, ulens, out_starts,
                                                                         out_len)
    used = int(stats[0])
    check(ok[:pages].all() and ok.tolist()[-1] is False, "the row group's pages all ok, the cut stream not")
    for other in groups[1:]:
        _, other_ok, _, _, _ = against_scan(other.data, other.starts.tolist(), other.clens.tolist(),
                                            other.ulens.tolist(), other.out_starts.tolist(), other.out_len)
        check(other_ok.all(), "a row group's pages all ok")
    print(f"[17 streams] K4 on {n} streams ({pages} pages of a {group.rows}-row group, {len(extra)} odd ones): "
          f"{int(stats[1])} rows in a table of {capacity}, {int(stats[2])} boundaries merged, {int(stats[3])} whole, "
          f"{int(stats[4])} slices charted ({int(stats[5])} met, {int(stats[6])} walked); "
          f"and on the other {len(groups) - 1} resident row groups ({sum(len(g.starts) for g in groups[1:])} pages; "
          f"all {len(groups)} made in {t_gen:.1f} s): equal to native.scan_blocks stream for stream", flush=True)

    # K1's ragged variant against the fixed-width K1, row for row.
    out = torch.zeros(out_len, dtype=torch.uint8, device=dev)
    flags = torch.from_numpy(ok.astype(np.uint8)).to(dev)
    r_ok, r_total = cuda_decode.decode_segments(args[0], rows, torch.tensor([used], device=dev), out, flags)
    fixed = torch.from_numpy(pack_rows(host, ins, cls)).to(dev)
    out_size = -(-max(int(uls.max()), 1) // 16) * 16
    f_out, f_ok, f_total = cuda_decode.decode_blocks(fixed, torch.from_numpy(cls).to(dev),
                                                     torch.from_numpy(uls).to(dev), out_size)
    r_ok, f_ok = r_ok[:used].cpu().numpy(), f_ok.cpu().numpy()
    check((r_ok == f_ok).all() and f_ok.all(), "the ragged K1's ok differs from the fixed K1's")
    check((r_total[:used].cpu().numpy() == f_total.cpu().numpy()).all(), "the ragged K1's totals differ")
    got, want = out.cpu().numpy(), f_out.cpu().numpy()
    for i in range(used):
        check(np.array_equal(got[outs[i] : outs[i] + uls[i]], want[i, : uls[i]]), f"ragged row {i} differs")
    del fixed, f_out
    print(f"[17 streams] K1's ragged variant on {used} rows equal to the fixed-width K1 on them packed "
          f"({out_size}-byte rows), row for row", flush=True)

    # The whole call against the plain reference and the generator's pages.
    t0 = time.perf_counter()
    before = profiling.counters()
    got_out, got_ok = distributed.decompress_streams(*args)
    torch.cuda.synchronize()
    moved = profiling.since(before)
    k4_launches, k1_launches = moved["k4.launches"], moved["k1.launches"]
    check(k4_launches == 1 and k1_launches == 1,
          f"decompress_streams launched K4 {k4_launches} and K1 {k1_launches} times for one call, not once each")
    ref_out, ref_ok = streams_reference.decompress_streams(*args)
    t_ref = time.perf_counter() - t0
    check(torch.equal(got_ok, ref_ok), "decompress_streams' flags differ from the reference's")
    covered = torch.zeros(out_len, dtype=torch.bool, device=dev)
    for s in np.flatnonzero(ok):
        covered[out_starts[s] : out_starts[s] + ulens[s]] = True
    check(torch.equal(got_out[covered], ref_out[covered]), "decompress_streams' pages differ from the reference's")
    host_out = got_out.cpu().numpy()
    for s, (o, u) in enumerate(zip(group.out_starts.tolist(), group.ulens.tolist())):
        check(np.array_equal(host_out[o : o + u], group.pages[o : o + u]), f"page {s} differs from the generator's")
    print(f"[17 streams] decompress_streams equal to the plain reference page for page ({t_ref:.1f} s with it) "
          f"and to the generator's pages; launches: K4 {k4_launches}, ragged K1 {k1_launches}", flush=True)

    # Device times on the row group alone, beside their bounds.
    rg = (args[0][: len(group.data)], *(a[:pages] for a in args[1:5]), group.out_len)
    k4_ms = time_device_fn(cuda_segment.segment_streams, rg) * 1e3
    rg_rows, rg_ok, rg_stats = cuda_segment.segment_streams(*rg)
    rg_out = torch.empty(group.out_len, dtype=torch.uint8, device=dev)
    k1_ms = time_device_fn(cuda_decode.decode_segments, (rg[0], rg_rows, rg_stats[:1], rg_out, rg_ok)) * 1e3
    call_ms = time_device_fn(distributed.decompress_streams, rg) * 1e3
    segs = int(rg_stats[1])
    slices, slices_met, slices_walked = (int(v) for v in rg_stats[4:7])
    met_share = 100 * slices_met / slices if slices else None
    walked_share = 100 * slices_walked / slices if slices else None
    comp_bytes = int(group.clens.sum())
    k4_bound = bound(comp_bytes + 24 * pages, 28 * segs + pages)
    # A walk of the tags alone skips the literals' bytes: its least read.
    payload = literal_payload(rg[0], group.starts, group.clens, group.ulens)
    k4_tag_bound = bound(comp_bytes - payload + 24 * pages, 28 * segs + pages)
    k1_bound = bound(comp_bytes + 28 * segs, int(group.ulens.sum()) + 5 * segs)
    sub = (args[0], *(a[:64] for a in args[1:5]), out_len)
    plain = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in sub)
    plain_ms = time_device_fn(cuda_segment.segment_streams_plain, (*plain, cuda_segment.capacity_for(64, out_len)),
                              iters=1, warmup=0) * 1e3
    sub_ms = time_device_fn(cuda_segment.segment_streams, sub) * 1e3
    k4_smem, k4_per_sm = cuda_segment.occupancy()
    print(f"[17 streams] K4: {k4_smem} bytes of shared memory a block, {k4_per_sm} blocks an SM; on the row group "
          f"{slices} slices charted, {slices_met} met ({met_share}%), {slices_walked} walked ({walked_share}%)",
          flush=True)
    print(f"[17 streams] on {card}, one row group ({pages} pages, {comp_bytes} stream bytes, "
          f"{int(group.ulens.sum())} page bytes, {segs} segments, {payload} of the stream bytes literals' "
          f"payload): K4 {k4_ms:.4f} ms (bound {k4_bound[0]:.4f}, {k4_bound[1]}, with every stream byte read; "
          f"{k4_tag_bound[0]:.4f} with the tags alone), ragged K1 {k1_ms:.4f} ms (bound {k1_bound[0]:.4f}), the whole call {call_ms:.4f} ms, "
          f"{int(group.ulens.sum()) / call_ms / 1e6:.2f} GB/s; K4 on the first 64 streams {sub_ms:.4f} ms, "
          f"its plain version {plain_ms:.1f} ms", flush=True)
    return {
        "name": "segment_streams",
        "route": "cuda",
        "source": "snappy_tpu_torch/csrc/segment_streams.cu",
        "replaces": None,
        "launches": k4_launches,
        "ragged_k1_launches": k1_launches,
        "max_abs_err": 0,
        "ms": k4_ms,
        "plain_ms": plain_ms,
        "ms_at_plain_shape": sub_ms,
        "bound_ms": k4_bound[0],
        "bound_by": k4_bound[1],
        "tag_bound_ms": k4_tag_bound[0],
        "library_ms": None,
        "ragged_k1_ms": k1_ms,
        "ragged_k1_bound_ms": k1_bound[0],
        "blocks_per_sm": k4_per_sm,
        "slices": slices,
        "slices_met_share": met_share,
        "slices_walked_share": walked_share,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import snappy_tpu_torch
    from snappy_tpu_torch import CorruptInputError
    from snappy_tpu_torch.core import varint
    from snappy_tpu_torch.native import libsnappy
    from snappy_tpu_torch.native import runtime as nat
    from snappy_tpu_torch.ops import (
        cuda_decode, cuda_decode_r4, cuda_encode, cuda_probes, decode_torch, encode_torch, kernels, route,
    )
    from snappy_tpu_torch.ops.encode_torch import ENC_PAD
    from snappy_tpu_torch.ops.host import blockify, pack_rows
    from snappy_tpu_torch.parallel import framed
    from snappy_tpu_torch.parallel import host as fhost
    from snappy_tpu_torch.tools import exp_vector_walk, profile_decode, profile_encode
    from snappy_tpu_torch.utils import profiling
    from snappy_tpu_torch.utils.metrics import Metrics, time_device_fn

    def device_ms(fn, args, iters: int, warmup: int = 1) -> float:
        return time_device_fn(fn, args, iters=iters, warmup=warmup) * 1e3

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(f"[1 device] {name} capability {cap[0]}.{cap[1]} count {torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    check(cap == (9, 0), f"expected an sm_90 card, got capability {cap}")

    # 2. build
    t0 = time.perf_counter()
    nat.max_compressed_length(0)
    t1 = time.perf_counter()
    kernels.load(*kernels.ENTRIES)
    t2 = time.perf_counter()
    print(f"[2 build] native g++ {t1 - t0:.2f} s, CUDA nvcc ({len(kernels.ENTRIES)} sources at once) {t2 - t1:.2f} s "
          f"(cached libraries load in ~0 s)", flush=True)

    # 3. kernel against its plain version on the card, one batch
    raw_main = corpus_stream(MAIN_BYTES)
    streams, _ = block_streams(nat, raw_main)
    good, _ = block_streams(nat, b"hello world " * 40)
    wrong, _ = block_streams(nat, b"A" * 1000)
    rle_raws = [b"\x00" * 8000, b"ab" * 4000, (b"x" * 100 + bytes(range(200))) * 26]
    rle = [block_streams(nat, r)[0][0] for r in rle_raws]
    trunc = bytes([59 << 2]) + bytes(range(60)) + bytes([0x02 | (63 << 2), 30])  # COPY_2 cut short
    cases = [(s, BLOCK, raw_main[i * BLOCK : (i + 1) * BLOCK]) for i, s in enumerate(streams[:128])]
    cases += [(b, 64, None) for b in (
        bytes([0x12, 0x00, 0x00]),  # copy offset 0
        bytes([0x61, 0x09, 0x20, 0x00]),  # copy reaches before output start
        bytes([39 << 2, 0x61, 0x62]),  # literal overruns input
        bytes([0xF8]),  # truncated long-form literal tag
        bytes([0x01]),  # truncated copy tag
        bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 255, 255]),  # COPY_4 wild offset
    )]
    cases += [(s, len(r), r) for s, r in zip(rle, rle_raws)]
    cases += [(wrong[0], 999, None), (wrong[0], 1001, None)]
    trailing = len(cases)  # K1 ignores the byte after the last tag; K3 reads it as a tag
    cases += [(good[0] + b"\x00", 480, b"hello world " * 40), (good[0], 480, b"hello world " * 40)]
    cases += [(trunc, 124, None)]
    # Corpus blocks with one byte changed or the tail cut, from a fixed
    # seed: whatever they decode to, kernel and plain version must agree.
    rng = np.random.default_rng(1)
    for s in streams[128:256]:
        b = bytearray(s)
        if rng.random() < 0.5:
            b[int(rng.integers(len(b)))] = int(rng.integers(256))
        else:
            b = b[: int(rng.integers(len(b)))]
        cases.append((bytes(b), BLOCK, ANY))
    bodies = [c[0] for c in cases]
    comp_np = pack_rows(
        np.frombuffer(b"".join(bodies), np.uint8),
        np.cumsum([0] + [len(b) for b in bodies[:-1]]),
        np.array([len(b) for b in bodies]),
    )
    comp = torch.from_numpy(comp_np).to(dev)
    clens = torch.tensor([len(b) for b in bodies], dtype=torch.int32, device=dev)
    ulens = torch.tensor([c[1] for c in cases], dtype=torch.int32, device=dev)
    k_out, k_ok, k_total = cuda_decode.decode_blocks(comp, clens, ulens, BLOCK)
    p_out, p_ok, p_total = decode_torch.decode_blocks(comp, clens, ulens, BLOCK)
    torch.cuda.synchronize()
    battery = (comp, clens, ulens)
    err3 = max_err(k_out, p_out)
    check(torch.equal(k_ok, p_ok), "kernel and plain version disagree on ok")
    check(err3 == 0 and torch.equal(k_out, p_out), "kernel and plain version disagree on out")
    check(torch.equal(k_total[k_ok], p_total[p_ok]), "kernel and plain version disagree on total")
    k_ok_np, k_out_np = k_ok.cpu().numpy(), k_out.cpu().numpy()
    for i, (_, ulen, expect) in enumerate(cases):
        if expect is ANY:
            continue
        check(bool(k_ok_np[i]) == (expect is not None), f"case {i}: ok={bool(k_ok_np[i])}")
        if expect is not None:
            check(k_out_np[i, :ulen].tobytes() == expect, f"case {i}: wrong bytes")
    # Lengths that do not fit the batch: the wrapper does not read them for
    # CUDA tensors, so the kernel's own guard must refuse those rows.
    g_clens, g_ulens = clens[:5].clone(), ulens[:5].clone()
    g_clens[0], g_clens[1] = comp.shape[1] - 3, -1
    g_ulens[2], g_ulens[3] = BLOCK + 1, -5
    g_out, g_ok, _ = cuda_decode.decode_blocks(comp[:5], g_clens, g_ulens, BLOCK)
    check(g_ok.tolist() == [False] * 4 + [True] and not bool(g_out[:4].any())
          and torch.equal(g_out[4], k_out[4]), "the kernel did not refuse lengths outside the batch")
    n_ok3 = int(k_ok.sum())
    # The rows at the edges of the kernel's window and ring, at 128 KiB.
    wrows = profile_decode.window_rows()
    w_bodies = [body for body, _ in wrows.values()]
    w_comp = pack_rows(np.frombuffer(b"".join(w_bodies), np.uint8),
                       np.cumsum([0] + [len(b) for b in w_bodies[:-1]]), np.array([len(b) for b in w_bodies]))
    w_args = (torch.from_numpy(w_comp).to(dev), torch.tensor([len(b) for b in w_bodies], dtype=torch.int32, device=dev),
              torch.tensor([len(raw) for _, raw in wrows.values()], dtype=torch.int32, device=dev), 2 * BLOCK)
    k_out, k_ok, k_total = cuda_decode.decode_blocks(*w_args)
    p_out, p_ok, p_total = decode_torch.decode_blocks(*w_args)
    err3 = max(err3, max_err(k_out, p_out))
    check(bool(k_ok.all()) and torch.equal(k_ok, p_ok) and err3 == 0 and torch.equal(k_out, p_out)
          and torch.equal(k_total, p_total), "kernel and plain version disagree on the window rows")
    for i, (wname, (_, raw)) in enumerate(wrows.items()):
        check(k_out[i, : len(raw)].cpu().numpy().tobytes() == raw, f"window row {wname}: wrong bytes")
    print(f"[3 kernel] {len(cases)} rows (128 corpus blocks + corrupt battery + RLE + wrong lengths "
          f"+ trailing byte + cut copy + 128 damaged blocks): out, ok identical to the plain version, total identical "
          f"where ok; {n_ok3} rows ok; max |kernel - plain| = {err3}; 4 rows with lengths "
          f"outside the batch refused; {len(wrows)} rows at the edges of the {profile_decode.window_bytes()}-byte "
          f"window and {profile_decode.ring_bytes()}-byte ring at 128 KiB ({', '.join(wrows)}): identical to the "
          f"plain version and to their bytes", flush=True)

    # 4. the slice at full size: a 64 MiB frame through the main path
    raws = [raw_main[i * BLOCK : (i + 1) * BLOCK] for i in range(len(streams))]
    frame = framed.build_frame(streams, raws, len(raw_main))
    before = profiling.counters()
    t0 = time.perf_counter()
    got = snappy_tpu_torch.uncompress_framed(frame, device="cuda")
    t_first = time.perf_counter() - t0
    main_launches = profiling.since(before)["k1.launches"]
    check(got == raw_main, "uncompress_framed returned wrong bytes")
    check(main_launches > 0, "the main path did not launch the CUDA kernel")
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = snappy_tpu_torch.uncompress_framed(frame, device="cuda")
        calls.append(time.perf_counter() - t0)
        check(again == raw_main, "repeat uncompress_framed returned wrong bytes")
    idx = framed.parse_index(frame)
    # The batch as uncompress_framed builds it: rows packed on the card,
    # held against the host's row-by-row pack.
    comp, clens, ulens, out_size = fhost.frame_batch(frame, idx, device=dev)
    b_clens = idx.comp_lens.astype(np.int64)
    b_starts = idx.payload_start + np.concatenate([[0], np.cumsum(b_clens)[:-1]])
    check(torch.equal(comp.cpu(), torch.from_numpy(pack_rows(np.frombuffer(frame, np.uint8), b_starts, b_clens))),
          "the rows packed on the card differ from pack_rows's")
    kernel_ms = device_ms(cuda_decode.decode_blocks, (comp, clens, ulens, out_size), 20)
    plain_ms = device_ms(decode_torch.decode_blocks, (comp, clens, ulens, out_size), 3)
    k1_bound = bound(int(b_clens.sum()) + 8 * len(b_clens), int(idx.total_len) + 5 * len(b_clens))
    k_out, k_ok, _ = cuda_decode.decode_blocks(comp, clens, ulens, out_size)
    p_out, p_ok, _ = decode_torch.decode_blocks(comp, clens, ulens, out_size)
    err4 = max_err(k_out, p_out)
    check(err4 == 0 and torch.equal(k_ok, p_ok) and bool(k_ok.all()), "kernel and plain differ at full size")
    del p_out, p_ok
    gb = len(raw_main) / 1e9
    smem, per_sm = cuda_decode.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[4 slice] 64 MiB frame, {idx.n_blocks} blocks, C={comp.shape[1]}, "
          f"compressed {len(frame)} bytes: byte-identical; rows packed on the card equal pack_rows's; kernel "
          f"launches {main_launches}; "
          f"first call {t_first:.4f} s; the kernel takes {smem} bytes of shared memory a block, {per_sm} blocks "
          f"an SM, {per_sm * sms} at once on {sms} SMs: {-(-idx.n_blocks // (per_sm * sms))} wave(s)", flush=True)
    print(f"[4 slice] on {card}: decode launch {kernel_ms:.4f} ms ({gb / kernel_ms * 1e3:.3f} GB/s), "
          f"plain version {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.3f} GB/s), whole call "
          f"min {min(calls):.4f} s ({gb / min(calls):.3f} GB/s) of {[round(c, 4) for c in calls]}",
          flush=True)

    # 5. raw streams
    before = profiling.counters()
    alice = snappy_tpu_torch.uncompress(read("alice29.snappy"), backend="torch", device="cuda")
    check(alice == read("alice29.txt"), "alice29.snappy decoded wrong")
    raw_stream = nat.compress(raw_main)
    t0 = time.perf_counter()
    got = snappy_tpu_torch.uncompress(raw_stream, backend="torch", device="cuda")
    t_raw = time.perf_counter() - t0
    check(got == raw_main, "64 MiB native raw stream decoded wrong")
    # One 300 KiB literal: scan_blocks declines it, so the stream is one row
    # of 300 KiB, which the kernel's ring and window take like any other.
    big = np.random.default_rng(7).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    header = varint.encode32(len(big))
    stream = header + bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    check(nat.scan_blocks(stream[len(header):], len(big)) is None, "300 KiB literal unexpectedly segmented")
    check(snappy_tpu_torch.uncompress(stream, backend="torch", device="cuda") == big,
          "unsegmentable stream decoded wrong")
    for bad in ("baddata1.snappy", "baddata2.snappy", "baddata3.snappy"):
        check(raises(CorruptInputError, lambda: snappy_tpu_torch.uncompress(
            read(bad), backend="torch", device="cuda")), f"{bad} did not raise")
    print(f"[5 raw] alice29.snappy, 64 MiB native stream ({t_raw:.4f} s whole call on {card}) and "
          f"an unsegmentable 300 KiB literal decoded byte-identical; baddata1-3 raise; "
          f"kernel launches {profiling.since(before)['k1.launches']}", flush=True)

    # 6. corrupt frames
    small = framed.build_frame(streams[:64], raws[:64], 64 * BLOCK)
    sidx = framed.parse_index(small)
    bad_crc = bytearray(small)
    bad_crc[sidx.payload_start - 4 * sidx.n_blocks + 4 * 3] ^= 0x40
    bad_block = bytearray(small)
    s, e = sidx.block_ranges()[5]
    bad_block[s:e] = b"\xff" * (e - s)
    check(snappy_tpu_torch.uncompress_framed(small, device="cuda") == raw_main[: 64 * BLOCK], "small frame")
    for label, bad in (("crc", bad_crc), ("block", bad_block)):
        check(raises(CorruptInputError, lambda: snappy_tpu_torch.uncompress_framed(bytes(bad), device="cuda")),
              f"damaged {label} did not raise")
    print("[6 corrupt] flipped crc and damaged block both raise CorruptInputError", flush=True)

    # 7. encode kernel against its plain version on the card, one batch
    width = BLOCK + ENC_PAD
    rng = np.random.default_rng(2)
    rows = [raw_main[i * BLOCK : (i + 1) * BLOCK] for i in range(128)]
    rows += [b"\xff" * BLOCK, b"\xff" * 5000, b"\xff\xff\xff\xff\x01" * 400, b"q" * BLOCK, b"ab" * 20000]
    rows += [r[:BLOCK] for r in rle_raws] + [b"", b"a", b"ab", b"abc", b"xyzw\x00\x00\x00\x00xyzw"]
    rows += [rng.integers(0, 256, 60000, dtype=np.uint8).tobytes(), bytes(range(256)) * 8]
    chase = profile_encode.chase_rows()
    rows += list(chase.values())
    e_blocks = np.zeros((len(rows) + 2, width), np.uint8)
    e_blens = np.zeros(len(rows) + 2, np.int32)
    for i, r in enumerate(rows):
        e_blocks[i, : len(r)] = np.frombuffer(r, np.uint8)
        e_blens[i] = len(r)
    e_blens[-2:] = [width - ENC_PAD + 1, -1]  # do not fit the batch: the kernel refuses them
    e_blocks[-2:, :BLOCK] = e_blocks[0, :BLOCK]
    blocks_t = torch.from_numpy(e_blocks).to(dev)
    blens_t = torch.from_numpy(e_blens).to(dev)
    err7 = 0
    for mp in (2, 1, 0, 3):
        k_out, k_olens = cuda_encode.encode_blocks(blocks_t, blens_t, mp)
        p_out, p_olens = encode_torch.encode_blocks(blocks_t, blens_t, mp)
        torch.cuda.synchronize()
        err7 = max(err7, max_err(k_out, p_out))
        check(torch.equal(k_olens, p_olens), f"min_profit {mp}: kernel and plain version disagree on olens")
        check(err7 == 0 and torch.equal(k_out, p_out), f"min_profit {mp}: kernel and plain version disagree on out")
        lens = k_olens.cpu().numpy()
        check(lens[-2:].tolist() == [-1, -1] and not bool(k_out[-2:].any()),
              "the encode kernel did not refuse blens outside the batch")
        out_np = k_out.cpu().numpy()
        for i, r in enumerate(rows):
            stream = bytes(varint.encode32(len(r))) + out_np[i, : lens[i]].tobytes()
            check(nat.uncompress(stream) == r, f"min_profit {mp}: row {i} does not decode to its block")
    print(f"[7 encode kernel] {len(rows) + 2} rows (128 corpus blocks + ff rows + RLE + lengths 0-3 + "
          f"match into the padding + random + the chase's {len(chase)} rows: {', '.join(chase)}; "
          f"+ 2 rows outside the batch), min_profit 2, 1, 0 and 3: out, olens identical to the plain version; "
          f"max |kernel - plain| = {err7}; every row decodes under the native decoder; 2 rows refused "
          f"(a chase chunk holds {profile_encode.record_chunk()} records)", flush=True)

    # 8. the write path at full size: the 64 MiB corpus mix through compress_framed
    before = profiling.counters()
    t0 = time.perf_counter()
    frame_w = snappy_tpu_torch.compress_framed(raw_main, device="cuda")
    t_first_w = time.perf_counter() - t0
    moved = profiling.since(before)
    enc_launches = moved["k2.launches"]
    check(enc_launches > 0, "compress_framed did not launch the CUDA encode kernel")
    check(moved["k1.launches"] == 0, "compress_framed launched the decoder")
    check(snappy_tpu_torch.uncompress_framed(frame_w, device="cuda") == raw_main,
          "the written frame does not decode through the port's CUDA decoder")
    check(nat.uncompress(framed.frame_to_raw(frame_w)) == raw_main,
          "the written frame does not decode through the native decoder")
    w_calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = snappy_tpu_torch.compress_framed(raw_main, device="cuda")
        w_calls.append(time.perf_counter() - t0)
        check(again == frame_w, "repeat compress_framed gave other bytes")
    buf, blens = blockify(np.frombuffer(raw_main, np.uint8), BLOCK)
    host_idx = route.host_blocks(buf, blens)
    dev_idx = np.setdiff1d(np.arange(len(blens)), host_idx)
    d_blocks = torch.from_numpy(buf[dev_idx]).to(dev)
    d_blens = torch.from_numpy(blens[dev_idx]).to(dev)
    enc_ms = device_ms(cuda_encode.encode_blocks, (d_blocks, d_blens, 2), 10)
    k_out, k_olens = cuda_encode.encode_blocks(d_blocks, d_blens, 2)
    k2_bound = bound(int(blens[dev_idx].sum()) + 4 * len(dev_idx), int(k_olens.sum()) + 4 * len(dev_idx))
    plain_runs = []
    # One run of the plain encoder (its walk is a host loop of ~13 s), kept
    # for the comparison below.
    enc_plain_ms = device_ms(lambda *a: plain_runs.append(encode_torch.encode_blocks(*a)),
                             (d_blocks, d_blens, 2), 1, warmup=0)
    p_out, p_olens = plain_runs.pop()
    err8 = max_err(k_out, p_out)
    check(err8 == 0 and torch.equal(k_out, p_out) and torch.equal(k_olens, p_olens),
          "encode kernel and plain version differ at full size")
    p_out, p_olens = p_out.cpu().numpy(), p_olens.cpu().numpy()
    streams_w = nat.compress_rows(buf, blens, np.arange(len(blens)))
    for j, i in enumerate(dev_idx.tolist()):
        streams_w[i] = p_out[j, : p_olens[j]].tobytes()
    check(framed.build_frame(streams_w, raws, len(raw_main)) == frame_w,
          "the written frame is not the plain version's blocks and the routed blocks' native streams")
    del p_out, k_out
    # The 32 KiB variant: the mix's device rows cut to 32 KiB blocks, a batch
    # of them held against the plain version byte for byte.
    n32 = 1 << 15
    buf32, blens32 = blockify(np.frombuffer(raw_main, np.uint8), n32)
    dev32 = np.setdiff1d(np.arange(len(blens32)), route.host_blocks(buf32, blens32))[:NARROW_ROWS]
    b32 = torch.from_numpy(buf32[dev32]).to(dev)
    l32 = torch.from_numpy(blens32[dev32]).to(dev)
    k32 = cuda_encode.encode_blocks(b32, l32, 2)
    p32 = encode_torch.encode_blocks(b32, l32, 2)
    check(torch.equal(k32[0], p32[0]) and torch.equal(k32[1], p32[1]),
          "encode kernel and plain version differ on 32 KiB rows")
    occ = {w: cuda_encode.occupancy(w) for w in (n32 + ENC_PAD, BLOCK + ENC_PAD)}
    check(occ[n32 + ENC_PAD][1] == 2 and occ[BLOCK + ENC_PAD][1] == 1,
          f"the encoder's blocks an SM by row width {occ}: want 2 for 32 KiB rows, 1 for 64 KiB")
    del k32, p32
    print(f"[8 write slice] {len(dev32)} device rows of the mix cut to 32 KiB: identical to the plain version; "
          f"the encoder's (shared memory a block, blocks an SM) by row width: {occ}", flush=True)
    print(f"[8 write slice] 64 MiB corpus mix, {len(blens)} blocks: {len(host_idx)} routed to the host, "
          f"{len(dev_idx)} on the card (all {len(dev_idx)} held against the plain version: identical); "
          f"frame {len(frame_w)} bytes, decodes through the CUDA and native decoders; encode kernel "
          f"launches {enc_launches}; first call {t_first_w:.4f} s", flush=True)
    print(f"[8 write slice] on {card}: encode launch ({len(dev_idx)} blocks) {enc_ms:.4f} ms "
          f"({len(dev_idx) * BLOCK / enc_ms / 1e6:.3f} GB/s), plain version {enc_plain_ms:.4f} ms; whole "
          f"compress_framed call min {min(w_calls):.4f} s ({gb / min(w_calls):.3f} GB/s) of "
          f"{[round(c, 4) for c in w_calls]}", flush=True)

    # 9. density gate and the raw write path
    worst = []
    for fname in DENSITY_FILES:
        data = read(fname)
        fbuf, fblens = blockify(np.frombuffer(data, np.uint8), BLOCK)
        _, olens = cuda_encode.encode_blocks(torch.from_numpy(fbuf).to(dev), torch.from_numpy(fblens).to(dev), 2)
        ours = int(olens.sum())
        theirs = len(nat.compress(data)) - len(varint.encode32(len(data)))
        check(ours <= theirs, f"{fname}: kernel {ours} bytes > native {theirs}")
        worst.append(ours / theirs)
    before = profiling.counters()
    t0 = time.perf_counter()
    raw_w = snappy_tpu_torch.compress(raw_main, backend="torch", device="cuda")
    t_raw_w = time.perf_counter() - t0
    check(profiling.since(before)["k2.launches"] > 0, "compress(backend='torch') did not launch the encode kernel")
    check(nat.uncompress(raw_w) == raw_main, "the raw stream from compress(backend='torch') does not decode")
    reframed = framed.raw_to_frame(raw_stream, device="cuda")
    check(snappy_tpu_torch.uncompress_framed(reframed, device="cuda") == raw_main,
          "raw_to_frame of a native raw stream does not decode")
    print(f"[9 density and raw] {len(DENSITY_FILES)} corpus files each no larger than native "
          f"(largest ratio {max(worst):.4f}); 64 MiB compress(backend='torch') {len(raw_w)} bytes in "
          f"{t_raw_w:.4f} s whole call on {card}, decodes; raw_to_frame of the native stream decodes", flush=True)

    # 10. K3 against its plain version on the card
    k_out, k_ok, k_total = cuda_decode_r4.decode_blocks(*battery, BLOCK)
    p_out, p_ok, p_total = decode_torch.decode_blocks_r4(*battery, BLOCK)
    torch.cuda.synchronize()
    err10 = max_err(k_out, p_out)
    check(torch.equal(k_ok, p_ok), "K3 and its plain version disagree on ok")
    check(err10 == 0 and torch.equal(k_out, p_out), "K3 and its plain version disagree on out")
    check(torch.equal(k_total[k_ok], p_total[p_ok]), "K3 and its plain version disagree on total")
    k_ok_np, k_out_np = k_ok.cpu().numpy(), k_out.cpu().numpy()
    for i, (_, ulen, expect) in enumerate(cases):
        if expect is ANY:
            continue
        want = expect is not None and i != trailing
        check(bool(k_ok_np[i]) == want, f"K3 case {i}: ok={bool(k_ok_np[i])}")
        if want:
            check(k_out_np[i, :ulen].tobytes() == expect, f"K3 case {i}: wrong bytes")
    # K3's envelope at its edges, in a batch of 128 KiB rows.
    big = np.random.default_rng(3).integers(0, 256, BLOCK + 1, dtype=np.uint8).tobytes()
    head = bytes([62 << 2]) + (BLOCK - 1).to_bytes(3, "little") + big[:BLOCK] + bytes([25 << 2]) + bytes(range(26))
    edge = [  # (body, ulen, K3 takes it)
        (head + bytes([0x03 | (63 << 2)]) + (65536).to_bytes(4, "little"), BLOCK + 26 + 64, False),
        (head + bytes([0x02 | (63 << 2), 0xFF, 0xFF]), BLOCK + 26 + 64, True),
        (head + bytes([0x03 | (63 << 2)]) + (65535).to_bytes(4, "little"), BLOCK + 26 + 64, True),
        (bytes([62 << 2]) + BLOCK.to_bytes(3, "little") + big, BLOCK + 1, False),
        (bytes([62 << 2]) + (BLOCK - 1).to_bytes(3, "little") + big[:BLOCK], BLOCK, True),
    ]
    wide = 2 * BLOCK
    e_comp_np = pack_rows(np.frombuffer(b"".join(e[0] for e in edge), np.uint8),
                          np.cumsum([0] + [len(e[0]) for e in edge[:-1]]), np.array([len(e[0]) for e in edge]))
    e_args = (torch.from_numpy(e_comp_np).to(dev),
              torch.tensor([len(e[0]) for e in edge], dtype=torch.int32, device=dev),
              torch.tensor([e[1] for e in edge], dtype=torch.int32, device=dev), wide)
    k_out, k_ok, k_total = cuda_decode_r4.decode_blocks(*e_args)
    p_out, p_ok, p_total = decode_torch.decode_blocks_r4(*e_args)
    _, k1_ok, _ = cuda_decode.decode_blocks(*e_args)
    err10 = max(err10, max_err(k_out, p_out))
    check(err10 == 0 and torch.equal(k_ok, p_ok) and torch.equal(k_total[k_ok], p_total[p_ok]),
          "K3 and its plain version disagree on the envelope rows")
    check(k_ok.tolist() == [e[2] for e in edge] and bool(k1_ok.all()),
          f"envelope rows: K3 ok {k_ok.tolist()}, K1 ok {k1_ok.tolist()}")
    for i, (body, ulen, takes) in enumerate(edge):
        if takes:
            check(k_out[i, :ulen].cpu().numpy().tobytes() == nat.uncompress(bytes(varint.encode32(ulen)) + body),
                  f"envelope row {i}: wrong bytes")
    # Lengths that do not fit the batch: the kernel's own guard refuses them.
    g_clens, g_ulens = e_args[1].clone(), e_args[2].clone()
    g_clens[0], g_clens[1] = e_comp_np.shape[1] - 3, -1
    g_ulens[3], g_ulens[4] = wide + 1, -5
    g_out, g_ok, _ = cuda_decode_r4.decode_blocks(e_args[0], g_clens, g_ulens, wide)
    check(g_ok.tolist() == [False, False, True, False, False] and not bool(g_out[[0, 1, 3, 4]].any())
          and torch.equal(g_out[2], k_out[2]), "K3 did not refuse lengths outside the batch")
    wide_smem, wide_per_sm = cuda_decode_r4.occupancy(wide)
    check(wide_smem < wide, f"K3 staged the {wide}-byte rows ({wide_smem} bytes of shared memory a block)")
    print(f"[10 r4 kernel] {len(cases)} battery rows + {len(edge)} envelope rows at 128 KiB: out, ok identical "
          f"to the plain version, total identical where ok; max |kernel - plain| = {err10}; the trailing byte, "
          f"offset 65,536 and a 65,537-byte literal refused (K1 takes all three); 4 rows with lengths outside "
          f"the batch refused; the 128 KiB rows in device memory ({wide_smem} bytes of shared memory a block, "
          f"{wide_per_sm} blocks an SM)", flush=True)

    # 11. the decode A/B: K1 against K3 on the same streams
    own_idx = framed.parse_index(frame_w)
    own = tuple(a.numpy() if torch.is_tensor(a) else a for a in fhost.frame_batch(frame_w, own_idx))
    own_streams = [frame_w[s:e] for s, e in own_idx.block_ranges()]
    gate = "libsnappy not installed: its gate did not run"
    if libsnappy.available():
        hdr = bytes(varint.encode32(BLOCK))
        for i in range(0, len(own_streams), 8):
            check(libsnappy.uncompress(hdr + own_streams[i]) == raws[i], f"own stream {i} does not decode under libsnappy")
        ls_total = sum(len(libsnappy.compress(r)) - len(hdr) for r in raws)
        own_total = sum(len(st) for st in own_streams)
        check(own_total <= ls_total, f"own streams {own_total} bytes > libsnappy {ls_total}")
        gate = (f"libsnappy gate ran: every 8th own stream decodes under it; own {own_total} bytes <= "
                f"libsnappy {ls_total}")
    ulen_f, hdr_f = varint.parse32(np.frombuffer(raw_stream, np.uint8), 0)
    body = np.frombuffer(raw_stream, np.uint8)[hdr_f:]
    starts, oplens = nat.scan_blocks(body, ulen_f)
    check(len(starts) == len(raws) and bool((oplens == BLOCK).all()), "the native stream's segments are not its blocks")
    f_clens = np.diff(np.append(starts, len(body))).astype(np.int32)
    foreign = (pack_rows(body, starts, f_clens), f_clens, oplens.astype(np.int32), BLOCK)
    ab = {"K1": cuda_decode.decode_blocks, "K3": cuda_decode_r4.decode_blocks}
    # bench.py's stage records for the A/B: K1 is its current kernel, K3 its
    # pinned control.
    ab_metrics = Metrics(run={"device": name, "card": card, "blocks": len(raws)})
    before_ab = profiling.counters()
    ab_rows = {}
    for label, batch, rounds in (("own", own, 3), ("foreign", foreign, 2)):
        args = (*(torch.from_numpy(a).to(dev) for a in batch[:3]), batch[3])
        outs = {}
        for kname, fn in ab.items():
            o, k, _ = fn(*args)
            check(bool(k.all()) and o.cpu().numpy().tobytes() == raw_main, f"{label}: {kname} is not bit-exact")
            outs[kname] = o
        rounds_ms = {kname: [] for kname in ab}
        for _ in range(rounds):
            for kname, fn in ab.items():
                rounds_ms[kname].append(device_ms(fn, args, 3))
        best = {kname: min(ts) for kname, ts in rounds_ms.items()}
        gbps = {kname: len(raw_main) / t / 1e6 for kname, t in best.items()}
        ab_rows[label] = (args, outs["K3"], best, batch[1])
        pick = max(gbps, key=gbps.get)
        if label == "own":
            ab_metrics.add(stage="decode_own", gbps_per_chip=gbps["K1"], seconds_per_batch=best["K1"] / 1e3,
                           rounds_ms=rounds_ms, kernel="cuda K1")
            ab_metrics.add(stage="decode_own_r4control", gbps_per_chip=gbps["K3"],
                           seconds_per_batch=best["K3"] / 1e3, vs_r4_same_run=gbps["K1"] / gbps["K3"],
                           kernel="cuda K3")
            ab_metrics.add(stage="decode_own_autotuned", gbps_per_chip=gbps[pick], picked=pick)
        else:
            ab_metrics.add(stage="decode_foreign", gbps_per_chip=gbps[pick], picked=pick, per_kernel_gbps=gbps,
                           rounds_ms=rounds_ms, vs_r4_same_run=gbps["K1"] / gbps["K3"])
        print(f"[11 decode A/B] {label}, {len(batch[1])} streams, {int(batch[1].sum())} bytes, on {card}: "
              f"K1 {gbps['K1']:.3f} GB/s, K3 {gbps['K3']:.3f} GB/s (best of {rounds} rounds, ms "
              f"{ {k: [round(t, 4) for t in ts] for k, ts in rounds_ms.items()} }); "
              f"vs_r4_same_run {gbps['K1'] / gbps['K3']:.3f}; pick {pick}", flush=True)
    r4_launches = profiling.since(before_ab)["k3.launches"]
    check(r4_launches > 0, "the decode A/B did not launch K3")
    err11 = 0
    for label, (args, k3_out, _, _) in ab_rows.items():
        p_out, p_ok, _ = decode_torch.decode_blocks_r4(*args)
        err11 = max(err11, max_err(k3_out, p_out))
        check(err11 == 0 and bool(p_ok.all()), f"{label}: K3 and its plain version differ")
    own_args, _, own_best, own_clens = ab_rows["own"]
    r4_ms = own_best["K3"]
    r4_plain_ms = device_ms(decode_torch.decode_blocks_r4, own_args, 3)
    k3_bound = bound(int(own_clens.sum()) + 8 * len(own_clens), len(raw_main) + 5 * len(own_clens))
    print(f"[11 decode A/B] gates before timing: both kernels bit-exact with every row ok on own and foreign "
          f"streams, K3 identical to its plain version (max |kernel - plain| = {err11}); {gate}; "
          f"K3 launches {r4_launches}; K3 plain version {r4_plain_ms:.4f} ms on the own streams", flush=True)
    k3_smem, k3_per_sm = cuda_decode_r4.occupancy(BLOCK)
    k1_smem, k1_per_sm = cuda_decode.occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_own = len(own_clens)
    print(f"[11 decode A/B] on {card}, {n_own} own streams: K3 {own_best['K3']:.4f} ms, {k3_smem} bytes of shared "
          f"memory a block, {k3_per_sm} blocks an SM ({-(-n_own // (k3_per_sm * sms))} waves); K1 "
          f"{own_best['K1']:.4f} ms, {k1_smem} bytes, {k1_per_sm} an SM ({-(-n_own // (k1_per_sm * sms))} waves)",
          flush=True)
    print(json.dumps({"decode_ab": ab_metrics.results}), flush=True)

    # 12. the probes P1-P6: gates, then the tool's timing runs as the main path
    t0 = time.perf_counter()
    probes = exp_vector_walk.probes("all", dev)
    edge_q0 = set(exp_vector_walk.drain_gate_inputs()[1][0].tolist())
    check({(1 << 31) - 2, (1 << 31) - 1} <= edge_q0, "P4's edge gate holds no q0 at INT_MAX - 1 and INT_MAX")
    gates = {p.name: exp_vector_walk.gate(p) for p in probes}
    print(f"[12 probes] {len(probes)} variants of P1-P6 identical to their plain versions at their gate knobs "
          f"(P2 and P3 also on the reference generator's stalled data, P4 on fields drawn per lane with repeated "
          f"rows and on rows past the arrays' ends, q0 at INT_MAX - 1 and INT_MAX among them, where q0 + 1 and "
          f"q0 + 2 wrap; P6 on rows past the output's ends)", flush=True)
    for variant, g in gates.items():
        print(f"[12 probes] {variant:30s} at knob {g['plain_knob']}: kernel {g['kernel_ms']:.4f} ms, "
              f"plain version {g['plain_ms']:.4f} ms", flush=True)
    before = profiling.counters()
    probe_rows = exp_vector_walk.run(probes, prefix="[12 probes] ")
    moved = profiling.since(before)
    probe_launches = {key: moved[f"probe.{key}.launches"] for key in cuda_probes.KERNELS}
    for key, n in probe_launches.items():
        check(n > 0, f"phase 12 did not launch the {key} kernel")
    rate = exp_vector_walk.l2_rate(dev)
    print(f"[12 probes] one-block L2 read identical to its plain version at {rate['tiles']} tiles of 16 KiB: "
          f"{rate['bytes_per_cycle']:.2f} bytes a cycle, {rate['gb_per_s']:.2f} GB/s", flush=True)
    print(f"[12 probes] on {card}: launches {probe_launches}; phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"probes": probe_rows}), flush=True)
    probe_entries = []
    for key, kname, replaces in PROBE_KERNELS:
        first = next(r for r in probe_rows if r["kernel"] == key)
        g = gates[first["probe"]]
        b = bound(first["in_bytes"], first["out_bytes"], first["ops"])
        probe_entries.append({
            "name": kname,
            "route": "cuda",
            "source": "snappy_tpu_torch/csrc/exp_vector_walk.cu",
            "replaces": replaces,
            "launches": probe_launches[key],
            "max_abs_err": max(gates[p.name]["max_abs_err"] for p in probes if p.kernel == key),
            "ms": first["ms_hi"],
            "plain_ms": g["plain_ms"],
            "bound_ms": b[0],
            "bound_by": b[1],
            "library_ms": None,
            "variant": first["probe"],
            "knob": first["knob_hi"],
            "plain_knob": g["plain_knob"],
            "ms_at_plain_knob": g["kernel_ms"],
        })

    # 13. the streaming pipeline at the reference's large config
    t0 = time.perf_counter()
    stream_launches = stream_phase(card, name, raw_main)
    print(f"[13 stream] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 14. the mesh and multi-host drivers
    t0 = time.perf_counter()
    mesh_launches = mesh_phase(card, raw_main, frame_w, dev)
    print(f"[14 mesh] phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 15. the array encoder
    print(json.dumps({"array_encoder": array_phase(card, raw_main, frame_w, dev)}), flush=True)

    # 16. the bench
    t0 = time.perf_counter()
    bench_launches = bench_phase(card, raw_main, frame_w, dev)
    print(f"[16 bench] launches over the phase {bench_launches}; phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 17. the batched raw-stream decoder
    t0 = time.perf_counter()
    k4_entry = streams_phase(card, dev)
    print(f"[17 streams] phase {time.perf_counter() - t0:.1f} s", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "decode_blocks",
        "route": "cuda",
        "source": "snappy_tpu_torch/csrc/decode_blocks.cu",
        "replaces": "snappy_tpu/ops/pallas_decode.py:297",
        "launches": main_launches,
        "stream_launches": stream_launches["decode_blocks"],
        "mesh_launches": mesh_launches["decode_blocks"],
        "multihost_launches": mesh_launches["multihost_decode_blocks"],
        "bench_launches": bench_launches["decode_blocks"],
        "max_abs_err": max(err3, err4),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "encode_blocks",
        "route": "cuda",
        "source": "snappy_tpu_torch/csrc/encode_blocks.cu",
        "replaces": "snappy_tpu/ops/pallas_encode.py:259",
        "launches": enc_launches,
        "stream_launches": stream_launches["encode_blocks"],
        "mesh_launches": mesh_launches["encode_blocks"],
        "multihost_launches": mesh_launches["multihost_encode_blocks"],
        "bench_launches": bench_launches["encode_blocks"],
        "max_abs_err": max(err7, err8),
        "ms": enc_ms,
        "plain_ms": enc_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None,
    }, {
        "name": "decode_blocks_r4",
        "route": "cuda",
        "source": "snappy_tpu_torch/csrc/decode_blocks_r4.cu",
        "replaces": "snappy_tpu/ops/pallas_decode_r4.py:270",
        "launches": r4_launches,
        "bench_launches": bench_launches["decode_blocks_r4"],
        "max_abs_err": max(err10, err11),
        "ms": r4_ms,
        "plain_ms": r4_plain_ms,
        "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1],
        "library_ms": None,
    }, k4_entry, *probe_entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
