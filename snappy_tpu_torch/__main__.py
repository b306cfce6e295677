"""Command-line interface: compress / decompress files.

    python -m snappy_tpu_torch compress   IN OUT [--format raw|framed|stream] [--device DEV]
    python -m snappy_tpu_torch decompress IN OUT [--resume] [--device DEV]
    python -m snappy_tpu_torch info       IN

Formats, the same as ``python -m snappy_tpu``'s, so files cross between
the two:
  raw     one wire-compatible Snappy stream, coded on the host
  framed  the block-parallel container (parallel/framed.py)
  stream  a sequence of frames with bounded memory and kill-resume
          support (parallel/streaming.py), the default for large files
Decompression detects the format (frame magic, frame sequence, raw varint
header). ``--resume`` restarts a killed stream decompression from the last
durable output (stream format only). ``--device`` is the torch device that
codes the framed and stream formats (default cuda); there is no fallback
to another device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _detect(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    from .parallel import framed

    return "framed_or_stream" if head[:8] == framed.MAGIC else "raw"


def cmd_compress(args) -> int:
    t0 = time.perf_counter()
    n = os.path.getsize(args.input)
    if args.format == "stream" or (args.format == "auto" and n > (64 << 20)):
        from .parallel import streaming

        csize = streaming.compress_file(args.input, args.output, device=args.device)
    elif args.format == "framed" or (args.format == "auto" and n > (1 << 20)):
        from .parallel.host import compress_framed

        with open(args.input, "rb") as f:
            frame = compress_framed(f.read(), device=args.device)
        with open(args.output, "wb") as f:
            f.write(frame)
        csize = len(frame)
    else:
        from . import compress

        with open(args.input, "rb") as f:
            out = compress(f.read())
        with open(args.output, "wb") as f:
            f.write(out)
        csize = len(out)
    dt = time.perf_counter() - t0
    print(
        f"{args.input}: {n} -> {csize} bytes "
        f"(ratio {csize / max(n, 1):.3f}, {n / dt / 1e6:.1f} MB/s)"
    )
    return 0


def cmd_decompress(args) -> int:
    t0 = time.perf_counter()
    kind = _detect(args.input)
    if kind == "framed_or_stream":
        from .parallel import streaming

        # One frame or a sequence of frames: the durable-frame scan tells
        # them apart. A file whose durable prefix is one frame followed by
        # more bytes (a run killed while writing its second frame) goes to
        # the stream path: uncompress_framed would decode only the first
        # frame and ignore --resume.
        durable, nframes, _ = streaming.scan_durable_frames(args.input)
        if nframes != 1 or durable != os.path.getsize(args.input):
            if args.resume:
                n = streaming.resume_uncompress_file(args.input, args.output, device=args.device)
            else:
                n = streaming.uncompress_file(args.input, args.output, device=args.device)
        else:
            from .parallel.host import uncompress_framed

            with open(args.input, "rb") as f:
                out = uncompress_framed(f.read(), device=args.device)
            with open(args.output, "wb") as f:
                f.write(out)
            n = len(out)
    else:
        from . import uncompress

        with open(args.input, "rb") as f:
            out = uncompress(f.read())
        with open(args.output, "wb") as f:
            f.write(out)
        n = len(out)
    dt = time.perf_counter() - t0
    print(f"{args.input}: -> {n} bytes ({n / dt / 1e6:.1f} MB/s)")
    return 0


def cmd_info(args) -> int:
    kind = _detect(args.input)
    size = os.path.getsize(args.input)
    if kind == "raw":
        import numpy as np

        from .core import varint

        with open(args.input, "rb") as f:
            head = np.frombuffer(f.read(8), np.uint8)
        ulen, hdr = varint.parse32(head, 0)
        print(f"raw snappy stream: {size} bytes, uncompressed {ulen} (header {hdr} B)")
    else:
        from .parallel import streaming

        durable, nframes, covered = streaming.scan_durable_frames(args.input)
        torn = size - durable
        print(
            f"frame sequence: {size} bytes, {nframes} durable frame(s) covering "
            f"{covered} uncompressed bytes"
            + (f", torn tail {torn} B" if torn else "")
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m snappy_tpu_torch", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compress")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--format", choices=["auto", "raw", "framed", "stream"], default="auto")
    c.add_argument("--device", default="cuda")
    c.set_defaults(fn=cmd_compress)
    d = sub.add_parser("decompress")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--resume", action="store_true")
    d.add_argument("--device", default="cuda")
    d.set_defaults(fn=cmd_decompress)
    i = sub.add_parser("info")
    i.add_argument("input")
    i.set_defaults(fn=cmd_info)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
