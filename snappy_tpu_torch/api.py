"""Top-level raw-format API with backend dispatch.

  - "native"  the C++ codec on the host (the default, as in snappy_tpu)
  - "torch"   block-parallel encode and decode on a torch device: the
              CUDA kernels on ``device="cuda"``, their plain torch versions
              on ``"cpu"`` (the counterpart of snappy_tpu's "xla" backend)

The "cpu" oracle backend is not ported yet.
"""

from __future__ import annotations

from .native import runtime as native_runtime


def compress(data, backend: str | None = None, device="cuda") -> bytes:
    """Compress ``data`` into a raw Snappy stream. ``device`` applies to
    the "torch" backend."""
    if backend in (None, "native"):
        return native_runtime.compress(data)
    if backend == "torch":
        from .ops import host

        return host.compress(data, device=device)
    raise ValueError(f"unknown backend {backend!r}")


def uncompress(data, backend: str | None = None, device="cuda") -> bytes:
    """Decode a raw Snappy stream produced by any conformant encoder.
    ``device`` applies to the "torch" backend."""
    if backend in (None, "native"):
        return native_runtime.uncompress(data)
    if backend == "torch":
        from .ops import host

        return host.uncompress(data, device=device)
    raise ValueError(f"unknown backend {backend!r}")


def uncompressed_length(data) -> tuple[int, int]:
    """(uncompressed length, header length) from a raw stream's varint."""
    return native_runtime.uncompressed_length(data)
