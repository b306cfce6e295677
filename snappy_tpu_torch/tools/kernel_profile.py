"""The engine of the ``clock64()`` kernel profilers (``profile_decode``,
``profile_decode_r4``, ``profile_encode``): a kernel source rewritten at its
anchors into a copy with counters, built beside other sources with the
package's nvcc command, and a block decoder launched from such a library.

A probe is (text in the kernel source, the same text with its counters[,
the times the text occurs, if not once]). An instrumented copy defines
``prof_read`` and ``prof_reset`` (its device counters to the host, and back
to zero) and may define ``prof_occupancy(row_c, out_size, smem, blocks)``.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor

import torch

from ..native import build as native_build
from ..ops import kernels

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# The profiling entry points an instrumented copy may define.
PROF_ENTRIES = {
    "prof_read": (ctypes.c_int, [_P]),
    "prof_reset": (ctypes.c_int, []),
    "prof_occupancy": (ctypes.c_int, [_I64, _I64, _P, _P]),
}


def instrument(src: str, probes) -> str:
    """``src`` with each probe's text replaced by its counters. Raises where
    a probe's text does not occur the number of times the probe states."""
    for old, new, *times in probes:
        times = times[0] if times else 1
        if src.count(old) != times:
            raise RuntimeError(f"the kernel source does not hold {old!r} {times} time(s)")
        src = src.replace(old, new)
    return src


def build(stem: str, sources: dict[str, str], defines=()) -> dict[str, ctypes.CDLL]:
    """Each (name -> a copy of the CUDA source ``csrc/<stem>.cu``) built into
    the package's build directory with ``defines``, one nvcc each, all at
    once; the libraries by name, with the entry points of ``stem`` and the
    profiling ones that the text defines bound."""
    out_dir = native_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = [str(kernels.nvcc_path()), *kernels.NVCC_FLAGS, *defines]
    entries = {**kernels.ENTRIES[stem], **PROF_ENTRIES}

    def one(item):
        name, text = item
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        lib = ctypes.CDLL(str(native_build.build_shared(compiler, [path], name)))
        for fn, (restype, argtypes) in entries.items():
            if f"{fn}(" in text:
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        return name, lib

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def launch_decoder(fn, comp, clens, ulens, out_size: int):
    """(out, ok, total) of the block decoder entry point ``fn`` (K1's or
    K3's signature) on a CUDA batch."""
    b, c = comp.shape
    out = torch.empty((b, out_size), dtype=torch.uint8, device=comp.device)
    ok = torch.empty(b, dtype=torch.bool, device=comp.device)
    total = torch.empty(b, dtype=torch.int32, device=comp.device)
    rc = fn(
        comp.data_ptr(), clens.data_ptr(), ulens.data_ptr(), b, c, out_size,
        out.data_ptr(), ok.data_ptr(), total.data_ptr(), torch.cuda.current_stream(comp.device).cuda_stream,
    )
    kernels.check(rc, f"{fn.__name__} launch")
    return out, ok, total
