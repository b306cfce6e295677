"""Where K3's cycles go, by phase, on one CUDA card.

    python -m snappy_tpu_torch.tools.profile_decode_r4

Builds an instrumented copy of ``csrc/decode_blocks_r4.cu`` into the build
directory: thread 0 of each block reads ``clock64()`` around the walk, the
literal drain, the parallel part of each copy group and the ordered pass
after it, and adds its totals to device counters. Then, on batches of 64 KiB
blocks encoded by the native encoder (the corpus mix that ``chip_smoke.py``
decodes, and 256 blocks of single corpus files), it prints K1's and K3's
times (CUDA events, median of 5 after a warm-up) and K3's cycles per block
by phase and its records, copy groups and groups that need the ordered
pass per block, from the instrumented copy, whose output must equal K3's, after
the card's name and power limit. The counts include each phase's barrier
waits. Requires a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..native import runtime as nat
from ..native.build import build_shared
from ..ops import cuda_decode, cuda_decode_r4, kernels
from ..ops.host import pack_rows
from ..utils.metrics import time_device_fn

BLOCK = 1 << 16
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MIX = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]
PHASES = ["walk", "literals", "copy groups", "ordered pass", "total"]
COUNTS = ["records", "groups", "groups with an ordered pass"]

# (text in the kernel source, the same text with its counters)
_PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_prof[8];\nnamespace {\n"),
    ("  bool more = fits;\n",
     "  long long c[8] = {0, 0, 0, 0, 0, 0, 0, 0}, t0 = clock64();\n  const long long t_begin = t0;\n"
     "  bool more = fits;\n"),
    ("    if (tid == 0) walk_chunk(in, clen, ulen, lit_src, lit_op, lit_n, cp_op, cp_f, cp_n, st);\n"
     "    __syncthreads();\n",
     "    t0 = clock64();\n"
     "    if (tid == 0) walk_chunk(in, clen, ulen, lit_src, lit_op, lit_n, cp_op, cp_f, cp_n, st);\n"
     "    __syncthreads();\n    c[0] += clock64() - t0; t0 = clock64();\n"),
    ("    if (!chunk_ok) break;\n", "    if (!chunk_ok) break;\n    c[5] += n_lit + n_cpy;\n"),
    ("      for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = in[s + j];\n    }\n    __syncthreads();\n",
     "      for (int64_t j = lane; j < n; j += kWarp) dst[op + j] = in[s + j];\n    }\n    __syncthreads();\n"
     "    c[1] += clock64() - t0; t0 = clock64();\n"),
    ("      __syncthreads();\n      if (any_after) {",
     "      __syncthreads();\n      c[2] += clock64() - t0; t0 = clock64();\n      ++c[6];\n      c[7] += any_after;\n"
     "      if (any_after) {"),
    ("        __syncthreads();\n      }\n    }\n  }\n  __syncthreads();\n",
     "        __syncthreads();\n      }\n      c[3] += clock64() - t0; t0 = clock64();\n    }\n  }\n"
     "  __syncthreads();\n  c[4] = clock64() - t_begin;\n"
     "  if (tid == 0)\n    for (int i = 0; i < 8; ++i) atomicAdd(&g_prof[i], (unsigned long long)c[i]);\n"),
    ('extern "C" {\n',
     'extern "C" {\nint prof_read(unsigned long long* h) { return cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n'
     "int prof_reset() { unsigned long long z[8] = {0}; return cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"),
]


def instrumented_library() -> ctypes.CDLL:
    src = (kernels.CSRC / "decode_blocks_r4.cu").read_text()
    for old, new in _PROBES:
        if src.count(old) != 1:
            raise RuntimeError(f"decode_blocks_r4.cu no longer holds {old!r}")
        src = src.replace(old, new)
    path = kernels.CSRC.parent / "_build" / "decode_blocks_r4_profiled.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = ctypes.CDLL(str(build_shared([str(kernels.nvcc_path()), *kernels.NVCC_FLAGS], [path], "r4_profiled")))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.snappy_cuda_decode_blocks_r4.argtypes = [p, p, p, i64, i64, i64, p, p, p, p]
    lib.prof_read.argtypes = [p]
    return lib


def block_batch(raw: bytes, dev):
    """The native encoder's streams of the 64 KiB blocks of ``raw`` as the
    block decoders' arguments on ``dev``."""
    n = len(raw) // BLOCK
    buf = np.frombuffer(raw[: n * BLOCK], np.uint8).reshape(n, BLOCK).copy()
    streams = nat.compress_rows(buf, np.full(n, BLOCK, np.int32), np.arange(n))
    clens = np.array([len(s) for s in streams], np.int64)
    comp = pack_rows(np.frombuffer(b"".join(streams), np.uint8), np.concatenate([[0], np.cumsum(clens)[:-1]]), clens)
    return (
        torch.from_numpy(comp).to(dev),
        torch.from_numpy(clens.astype(np.int32)).to(dev),
        torch.full((n,), BLOCK, dtype=torch.int32, device=dev),
        BLOCK,
    )


def repeat_to(data: list[bytes], n: int) -> bytes:
    out, total, i = [], 0, 0
    while total < n:
        out.append(data[i % len(data)])
        total += len(out[-1])
        i += 1
    return b"".join(out)[:n]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode_r4: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    files = {n: open(os.path.join(REPO, "testdata", n), "rb").read() for n in MIX}
    sets = {"corpus mix, 1024 blocks": repeat_to([files[n] for n in MIX], 1024 * BLOCK)}
    for n in ("alice29.txt", "html", "kppkn.gtb", "fireworks.jpeg"):
        sets[f"{n}, 256 blocks"] = repeat_to([files[n]], 256 * BLOCK)
    lib = instrumented_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for label, raw in sets.items():
        args = block_batch(raw, dev)
        b = args[0].shape[0]
        k1 = time_device_fn(cuda_decode.decode_blocks, args, iters=5, warmup=1) * 1e3
        k3 = time_device_fn(cuda_decode_r4.decode_blocks, args, iters=5, warmup=1) * 1e3
        want = cuda_decode_r4.decode_blocks(*args)
        out = torch.empty_like(want[0])
        ok = torch.empty_like(want[1])
        total = torch.empty_like(want[2])
        lib.prof_reset()
        rc = lib.snappy_cuda_decode_blocks_r4(
            args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), b, args[0].shape[1], BLOCK,
            out.data_ptr(), ok.data_ptr(), total.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        kernels.check(rc, "instrumented decode_blocks_r4 launch")
        torch.cuda.synchronize()
        if not (bool(want[1].all()) and torch.equal(out, want[0]) and torch.equal(ok, want[1])):
            raise RuntimeError(f"{label}: the instrumented copy differs from K3")
        counts = (ctypes.c_ulonglong * 8)()
        lib.prof_read(counts)
        per = {ph: counts[i] / b for i, ph in enumerate(PHASES + COUNTS)}
        shares = ", ".join(f"{ph} {per[ph]:.0f} ({per[ph] / per['total']:.1%})" for ph in PHASES[:4])
        tally = ", ".join(f"{per[k]:.1f} {k}" for k in COUNTS)
        print(f"{label}: {int(args[1].sum())} compressed bytes; K1 {k1:.4f} ms, K3 {k3:.4f} ms; "
              f"K3 cycles per block {per['total']:.0f}: {shares}; per block {tally}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
