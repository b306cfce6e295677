"""Build the native C++ codec shared library.

The source is the port's own ``snappy_native.cpp``, a byte-for-byte copy
of the JAX package's codec, compiled with ``crc32_rows.cpp`` (the framed
container's crcs, many blocks a call) into this package's build directory,
so the package builds with nothing of the JAX package beside it. Built on
first use, or by hand:

    python -m snappy_tpu_torch.native.build

``build_shared`` is also how ``ops/kernels.py`` builds the CUDA sources.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
SOURCE = _HERE / "snappy_native.cpp"
CRC_SOURCE = _HERE / "crc32_rows.cpp"

# No -march=native: the build directory may travel with a copy of the tree
# to another host, and the library is keyed by source and flags only.
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fno-exceptions", "-fno-rtti", "-Wall"]


def build_shared(compiler: list[str], sources: list[Path], stem: str) -> Path:
    """Compile ``sources`` into ``BUILD_DIR/<stem>-<hash>.so`` unless a
    library built from the same sources and command already exists.

    The hash covers the command and every source's bytes, so an edited
    source rebuilds. The output is written to a temporary file and renamed,
    so concurrent builders never load a half-written library. Raises
    ``RuntimeError`` with the compiler's output when the build fails.
    """
    h = hashlib.sha256(" ".join(compiler).encode())
    for src in sources:
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*compiler, *map(str, sources), "-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"build of {stem} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def build() -> Path:
    """Path of the native codec library, compiling it if needed."""
    return build_shared(["g++", *CXXFLAGS], [SOURCE, CRC_SOURCE], "snappy_native")


if __name__ == "__main__":
    print(build(), file=sys.stderr)
