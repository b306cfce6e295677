"""The card's peaks and the least time a kernel's bytes take.

The byte counts are those the data needs, each input byte read once and
each output byte written once, whatever a kernel reads again: a block
decoder reads its streams and lengths (8 bytes a row) and writes the
uncompressed bytes, a flag and a length (5 bytes a row), as the program's
``tools/bench.py::hbm_roofline_frac`` counted when this copy was taken; a
block encoder reads its blocks and lengths (4 bytes a row) and writes its
streams and lengths (4 bytes a row).
"""

from __future__ import annotations

# Published peaks by the name ``torch.cuda.get_device_name`` gives (NVIDIA's
# data sheet; SXM part, 700 W).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str) -> float | None:
    peak = PEAKS.get(kind)
    return None if peak is None else peak["hbm_bytes_per_s"]


def decode_bytes(comp_bytes: int, rows: int, out_bytes: int) -> int:
    """Bytes a block decode moves at least."""
    return comp_bytes + 8 * rows + out_bytes + 5 * rows


def encode_bytes(in_bytes: int, rows: int, comp_bytes: int) -> int:
    """Bytes a block encode moves at least."""
    return in_bytes + 4 * rows + comp_bytes + 4 * rows


def share(nbytes: int, seconds: float, kind: str) -> float | None:
    """The least time of ``nbytes`` on the card ``kind`` over ``seconds``,
    in percent; None where the card's peak or the time is unknown."""
    peak = hbm_bytes_per_s(kind)
    if peak is None or not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / peak / seconds
