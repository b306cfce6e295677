"""Top-level raw-format API with backend dispatch.

  - "native"  the C++ codec on the host
  - "torch"   block-parallel encode and decode on a torch device: the
              CUDA kernels on ``device="cuda"``, their plain torch versions
              on ``"cpu"`` (the counterpart of snappy_tpu's "xla" backend)
  - "cpu"     the scalar NumPy oracle (``cpu/oracle.py``)
  - None      the native codec where it builds and loads, else the oracle,
              as in snappy_tpu
"""

from __future__ import annotations

from .cpu import oracle
from .native import runtime as native_runtime


def _host_codec(backend: str | None):
    """The module (with ``compress`` and ``uncompress``) of a host backend."""
    if backend == "native" or (backend is None and native_runtime.available()):
        return native_runtime
    if backend in (None, "cpu"):
        return oracle
    raise ValueError(f"unknown backend {backend!r}")


def compress(data, backend: str | None = None, device="cuda", encoder: str = "kernel") -> bytes:
    """Compress ``data`` into a raw Snappy stream. ``device`` and
    ``encoder`` (the block encoder: "kernel" or "array", see
    ``ops/select.py``) apply to the "torch" backend."""
    if backend == "torch":
        from .ops import host

        return host.compress(data, device=device, encoder=encoder)
    return _host_codec(backend).compress(data)


def uncompress(data, backend: str | None = None, device="cuda") -> bytes:
    """Decode a raw Snappy stream produced by any conformant encoder.
    ``device`` applies to the "torch" backend."""
    if backend == "torch":
        from .ops import host

        return host.uncompress(data, device=device)
    return _host_codec(backend).uncompress(data)


def uncompressed_length(data) -> tuple[int, int]:
    """(uncompressed length, header length) from a raw stream's varint
    header, parsed without the native library, as the reference does."""
    return oracle.uncompressed_length(data)
