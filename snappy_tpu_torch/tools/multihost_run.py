"""One process of a multi-host framed run.

    python -m snappy_tpu_torch.tools.multihost_run COORDINATOR NPROCS RANK IN FRAME OUT
        [--device cuda|cpu] [--local-shards K] [--decode-only] [--encoder kernel|array]
        [--timeout SECONDS]

Start NPROCS of these, ranks 0 to NPROCS-1, with the same COORDINATOR
(``host:port``, where rank 0 listens). Each joins the gloo process group
(``parallel/multihost.py::initialize``), builds the global mesh of K
shards a process, compresses IN into the frame FRAME with
``multihost.compress_framed`` (with the block encoder ``--encoder``, K2 by
default) and decompresses FRAME into OUT with
``multihost.uncompress_framed``; with ``--decode-only`` FRAME must exist
and only the decompress runs. Every process must see the same files.

``--device cuda`` (the default) puts a process's shards on
``cuda:{rank % cards}``, so several processes may share one card;
``--device cpu`` runs the kernels' plain versions, each process on its
share of the host's cores. Each process prints one
JSON line: its rank, the mesh's size, the frame's and the output's bytes,
the wall time of each call (host clock) and its kernel launches. On a card
the CUDA context and the kernels' libraries are set up first, timed apart
(``setup_s``). A rank that fails exits non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import torch
import torch.distributed as dist

from ..ops import cuda_decode, cuda_encode, kernels, select
from ..parallel import multihost


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.multihost_run", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("coordinator")
    p.add_argument("nprocs", type=int)
    p.add_argument("rank", type=int)
    p.add_argument("in_path")
    p.add_argument("frame_path")
    p.add_argument("out_path")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--local-shards", type=int, default=1)
    p.add_argument("--decode-only", action="store_true")
    p.add_argument("--encoder", default="kernel", choices=select.ENCODERS, help="the block encoder")
    p.add_argument("--timeout", type=float, default=300.0, help="seconds a collective may wait")
    args = p.parse_args(argv)

    multihost.initialize(args.coordinator, args.nprocs, args.rank,
                         timeout=datetime.timedelta(seconds=args.timeout))
    try:
        if args.device == "cpu":
            # The processes share one host: more threads than cores stalls
            # them. Each takes at most its share (and no more than it has).
            torch.set_num_threads(min(torch.get_num_threads(), max(1, (os.cpu_count() or 1) // args.nprocs)))
        dev = multihost.local_device() if args.device == "cuda" else torch.device("cpu")
        mesh = multihost.global_mesh([dev] * args.local_shards)
        rec = {"rank": args.rank, "world": dist.get_world_size(), "mesh": mesh.size, "device": str(dev)}
        if dev.type == "cuda":
            t0 = time.perf_counter()
            torch.zeros(1, device=dev)
            kernels.load("encode_blocks", "decode_blocks")
            rec["setup_s"] = time.perf_counter() - t0
        cuda_encode.launches = cuda_decode.launches = 0
        if not args.decode_only:
            t0 = time.perf_counter()
            rec["frame_bytes"] = multihost.compress_framed(args.in_path, args.frame_path, mesh=mesh,
                                                           encoder=args.encoder)
            rec["compress_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["bytes"] = multihost.uncompress_framed(args.frame_path, args.out_path, mesh=mesh)
        rec["uncompress_s"] = time.perf_counter() - t0
        rec["launches"] = {"encode_blocks": cuda_encode.launches, "decode_blocks": cuda_decode.launches}
        print(json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
