#!/usr/bin/env python3
"""Drive snappy_tpu_torch's read path once on one CUDA GPU (Hopper, sm_90).

    python3 chip_smoke.py

Run from the root of the repository, with no arguments; it uses one card
(cuda:0). Phases, one line each (plus details), and any failure exits
non-zero:

  1. device   name, capability (must be 9.0), nvidia-smi name and power limit
  2. build    the native C++ codec (g++) and the CUDA kernel (nvcc)
  3. kernel   the CUDA block decoder against its plain torch version on one
              batch on the card: 128 corpus blocks of 64 KiB, the corrupt
              battery, RLE blocks, wrong claimed lengths, a trailing byte,
              128 corpus blocks damaged at random (fixed seed); then rows
              whose lengths do not fit the batch, which the kernel refuses
  4. slice    a 64 MiB corpus-mix frame (1024 blocks, crc on) through
              uncompress_framed(frame, device="cuda"): the main path; the
              kernel's launch count is reset just before and read just after
  5. raw      alice29.snappy, a 64 MiB native raw stream and an unsegmentable
              stream through uncompress(backend="torch", device="cuda");
              baddata{1,2,3}.snappy must raise CorruptInputError
  6. corrupt  a frame with a flipped crc and one with a damaged block must raise

Before the last line it prints the card's `nvidia-smi` name and power limit
and one JSON line {"kernels": [...]} with each kernel's launches on the main
path, its largest difference from the plain version, and its time beside
the plain version's at the main path's shape. Times are informational. The
last line is {"ok": true, "device": {...}}. Without a CUDA device it exits
with code 2 and prints no result. It imports no JAX and nothing of
snappy_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK = 1 << 16
ANY = object()  # a case whose result only has to agree between kernel and plain version
MAIN_BYTES = 64 << 20
# The same mix, in the same order, as bench.py's corpus stream.
CORPUS = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
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


def cuda_ms(fn, iters: int) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` runs (CUDA
    events around each run, after one warm-up run)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import snappy_tpu_torch
    from snappy_tpu_torch import CorruptInputError
    from snappy_tpu_torch.core import varint
    from snappy_tpu_torch.native import runtime as nat
    from snappy_tpu_torch.ops import cuda_decode, decode_torch, kernels
    from snappy_tpu_torch.ops.host import pack_rows
    from snappy_tpu_torch.parallel import framed
    from snappy_tpu_torch.parallel import host as fhost

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
    kernels.load()
    t2 = time.perf_counter()
    print(f"[2 build] native g++ {t1 - t0:.2f} s, CUDA nvcc {t2 - t1:.2f} s "
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
    err3 = int((k_out.int() - p_out.int()).abs().max())
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
    print(f"[3 kernel] {len(cases)} rows (128 corpus blocks + corrupt battery + RLE + wrong lengths "
          f"+ trailing byte + cut copy + 128 damaged blocks): out, ok identical to the plain version, total identical "
          f"where ok; {int(k_ok.sum())} rows ok; max |kernel - plain| = {err3}; 4 rows with lengths "
          f"outside the batch refused", flush=True)

    # 4. the slice at full size: a 64 MiB frame through the main path
    raws = [raw_main[i * BLOCK : (i + 1) * BLOCK] for i in range(len(streams))]
    frame = framed.build_frame(streams, raws, len(raw_main))
    cuda_decode.launches = 0
    t0 = time.perf_counter()
    got = snappy_tpu_torch.uncompress_framed(frame, device="cuda")
    t_first = time.perf_counter() - t0
    main_launches = cuda_decode.launches
    check(got == raw_main, "uncompress_framed returned wrong bytes")
    check(main_launches > 0, "the main path did not launch the CUDA kernel")
    calls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = snappy_tpu_torch.uncompress_framed(frame, device="cuda")
        calls.append(time.perf_counter() - t0)
        check(again == raw_main, "repeat uncompress_framed returned wrong bytes")
    idx = framed.parse_index(frame)
    b_comp, b_clens, b_ulens, out_size = fhost.frame_batch(frame, idx)
    comp = torch.from_numpy(b_comp).to(dev)
    clens = torch.from_numpy(b_clens).to(dev)
    ulens = torch.from_numpy(b_ulens).to(dev)
    kernel_ms = cuda_ms(lambda: cuda_decode.decode_blocks(comp, clens, ulens, out_size), 20)
    plain_ms = cuda_ms(lambda: decode_torch.decode_blocks(comp, clens, ulens, out_size), 3)
    k_out, k_ok, _ = cuda_decode.decode_blocks(comp, clens, ulens, out_size)
    p_out, p_ok, _ = decode_torch.decode_blocks(comp, clens, ulens, out_size)
    err4 = int((k_out.int() - p_out.int()).abs().max())
    check(err4 == 0 and torch.equal(k_ok, p_ok) and bool(k_ok.all()), "kernel and plain differ at full size")
    del p_out, p_ok
    gb = len(raw_main) / 1e9
    print(f"[4 slice] 64 MiB frame, {idx.n_blocks} blocks, C={b_comp.shape[1]}, "
          f"compressed {len(frame)} bytes: byte-identical; kernel launches {main_launches}; "
          f"first call {t_first:.4f} s", flush=True)
    print(f"[4 slice] on {card}: decode launch {kernel_ms:.4f} ms ({gb / kernel_ms * 1e3:.3f} GB/s), "
          f"plain version {plain_ms:.4f} ms ({gb / plain_ms * 1e3:.3f} GB/s), whole call "
          f"min {min(calls):.4f} s ({gb / min(calls):.3f} GB/s) of {[round(c, 4) for c in calls]}",
          flush=True)

    # 5. raw streams
    before = cuda_decode.launches
    alice = snappy_tpu_torch.uncompress(read("alice29.snappy"), backend="torch", device="cuda")
    check(alice == read("alice29.txt"), "alice29.snappy decoded wrong")
    raw_stream = nat.compress(raw_main)
    t0 = time.perf_counter()
    got = snappy_tpu_torch.uncompress(raw_stream, backend="torch", device="cuda")
    t_raw = time.perf_counter() - t0
    check(got == raw_main, "64 MiB native raw stream decoded wrong")
    # One 300 KiB literal: scan_blocks declines it, and the row is wider
    # than shared memory, so the kernel reads it from device memory.
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
          f"kernel launches {cuda_decode.launches - before}", flush=True)

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

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "decode_blocks",
        "route": "cuda",
        "source": "snappy_tpu_torch/csrc/decode_blocks.cu",
        "replaces": "snappy_tpu/ops/pallas_decode.py:297",
        "launches": main_launches,
        "max_abs_err": max(err3, err4),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
