"""The probe kernels P1-P6 on the card: the wrappers of ``csrc/exp_vector_walk.cu``.

The counterparts of the Pallas kernels of ``benchmarks/exp_vector_walk.py``,
one wrapper a kernel, with the contracts of the plain versions in
``ops/probes_torch.py`` (same arguments, same results): ``chain`` (P1),
``walk8`` (P2), ``walk_scalar`` (P3), ``drain`` (P4), ``scalar_loop`` (P5)
and ``when_drain`` (P6). The knob is a Python int. Beside them ``l2_read``,
which ports no TPU kernel and counts no launch: one block's
read of a buffer from L2, whose cycles bound a one-block drain.

A CUDA tensor launches the kernel on the current stream and returns without
synchronising, or raises. Given ``cycles``, an int64[1] tensor on the same
card, the kernel writes there the clock64() span of its block 0, from which
two knobs give cycles a step. Given ``lib``, another build of the same
entry points (such as a parent commit's copy of the source, which
``tools/exp_vector_walk.py --parent`` builds), the launch goes to it and is
not counted. Every other launch counts under ``probe.<kernel>.launches``,
``<kernel>`` one of ``KERNELS``. A CPU tensor goes to the plain version, which
counts no cycles and takes no ``lib``. No other device is taken.

P2 takes one length a walk, where the reference takes one a lane: its kernel
walks each walk with one thread. A group whose walks' lengths differ over
their 128 lanes is refused on either device, as the kernel refuses it
without reading the lengths on the host: its meta is (-1, -1), which no
group that is walked gives, and its records are ``INT_MIN``.
"""

from __future__ import annotations

import torch

from ..utils.profiling import count
from . import kernels, probes_torch
from .probes_torch import (
    CHAIN_MODES, DRAIN_MODES, LANES, NCP, R_ROWS, SCALAR_VARIANTS, WHEN_MODES, WHEN_OUT_ROWS,
    WHEN_RECORDS, WHEN_SRC_ROWS,
)

# The probe kernels, as their launch counters name them.
KERNELS = ("chain", "walk8", "walk_scalar", "drain", "scalar_loop", "when_drain")
_INT_MAX = (1 << 31) - 1
_SCALAR_VARIANTS = {v[1:] for v in SCALAR_VARIANTS}  # (work, unroll, cond, chain)


def _check(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor | None = None) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or tuple(t.shape) != shape:
        got = f"{t.dtype}{list(t.shape)}" if isinstance(t, torch.Tensor) else type(t).__name__
        raise TypeError(f"{name} must be int32{list(shape)}, got {got}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, the other arguments on {like.device}")


def _knob(knob: int, hi: int) -> None:
    if not isinstance(knob, int) or not 0 <= knob <= hi:
        raise ValueError(f"knob must be an int in [0, {hi}], got {knob!r}")


def _mode(mode: str, modes: tuple) -> int:
    if mode not in modes:
        raise ValueError(f"mode must be one of {modes}, got {mode!r}")
    return modes.index(mode)


def _on_card(t: torch.Tensor, cycles: torch.Tensor | None, lib) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type == "cpu":
        if cycles is not None or lib is not None:
            raise ValueError("cycles and lib are for the kernels, on the card")
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {t.device}")
    if cycles is not None and (cycles.dtype != torch.int64 or cycles.numel() != 1 or cycles.device != t.device):
        raise ValueError(f"cycles must be int64[1] on {t.device}")
    return True


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes: the
    kernels copy rows into shared memory 16 bytes a piece (cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(kernel: str | None, entry: str, device, cycles, *args, lib=None) -> None:
    """Launch ``entry`` and count it under ``probe.<kernel>.launches`` (not
    for another build, ``lib``, nor for ``kernel`` None)."""
    with torch.cuda.device(device):
        rc = getattr(lib if lib is not None else kernels.load("exp_vector_walk"), entry)(
            *args, cycles.data_ptr() if cycles is not None else None, torch.cuda.current_stream(device).cuda_stream
        )
    kernels.check(rc, f"{entry} launch")
    if lib is None and kernel is not None:
        count(f"probe.{kernel}.launches")


def chain(knob: int, x: torch.Tensor, mode: str, cycles: torch.Tensor | None = None, lib=None) -> torch.Tensor:
    """P1 on x int32[G, 8, 128], G 1 or 4; see ``probes_torch.chain``."""
    g = x.shape[0] if isinstance(x, torch.Tensor) and x.dim() == 3 else 0
    if g not in (1, 4):
        raise TypeError("x must be int32[G, 8, 128] with G 1 or 4")
    _check("x", x, (g, 8, LANES))
    m = _mode(mode, CHAIN_MODES)
    _knob(knob, _INT_MAX)
    if not _on_card(x, cycles, lib):
        return probes_torch.chain(knob, x, mode)
    out = torch.empty_like(x)
    _launch("chain", "snappy_probe_chain", x.device, cycles, m, g, knob, x.data_ptr(), out.data_ptr(), lib=lib)
    return out


def walk8(knob: int, clen: torch.Tensor, cmds: torch.Tensor, cycles: torch.Tensor | None = None, lib=None):
    """P2 on clen int32[g, 8, 128], cmds int32[g, R_ROWS, 8, 128]; see
    ``probes_torch.walk8`` and, for the lengths, the module docstring."""
    g = cmds.shape[0] if isinstance(cmds, torch.Tensor) and cmds.dim() == 4 else 0
    _check("cmds", cmds, (g, R_ROWS, 8, LANES))
    _check("clen", clen, (g, 8, LANES), like=cmds)
    _knob(knob, R_ROWS)
    if not _on_card(cmds, cycles, lib):
        rec, meta = probes_torch.walk8(knob, clen, cmds)
        ragged = (clen != clen[..., :1]).flatten(1).any(1)
        rec[ragged] = probes_torch.INT_MIN
        meta[ragged] = -1
        return rec, meta
    rec = torch.empty((g, probes_torch.T_TILES, 8, LANES), dtype=torch.int32, device=cmds.device)
    meta = torch.empty((g, 1, 2), dtype=torch.int32, device=cmds.device)
    if g:
        cmds = _aligned16(cmds)
        _launch("walk8", "snappy_probe_walk8", cmds.device, cycles, g, knob, clen.data_ptr(), cmds.data_ptr(),
                rec.data_ptr(), meta.data_ptr(), lib=lib)
    return rec, meta


def walk_scalar(knob: int, clen: torch.Tensor, cmds: torch.Tensor, cycles: torch.Tensor | None = None,
                lib=None):
    """P3 on clen int32[n, 1, 1], cmds int32[n, 1, NCP]; see
    ``probes_torch.walk_scalar``."""
    n = cmds.shape[0] if isinstance(cmds, torch.Tensor) and cmds.dim() == 3 else 0
    _check("cmds", cmds, (n, 1, NCP))
    _check("clen", clen, (n, 1, 1), like=cmds)
    _knob(knob, _INT_MAX // NCP)  # the reference's step count stays in int32
    if not _on_card(cmds, cycles, lib):
        return probes_torch.walk_scalar(knob, clen, cmds)
    meta = torch.empty((n, 1, 2), dtype=torch.int32, device=cmds.device)
    if n:
        _launch("walk_scalar", "snappy_probe_walk_scalar", cmds.device, cycles, n, knob * NCP // 5 // 16 + 1,
                clen.data_ptr(), cmds.data_ptr(), meta.data_ptr(), lib=lib)
    return meta


def drain(knob: int, q0: torch.Tensor, r: torch.Tensor, fld: torch.Tensor, src: torch.Tensor, mode: str,
          cycles: torch.Tensor | None = None, lib=None) -> torch.Tensor:
    """P4 of N records (N a multiple of 8) on q0, r int32[N], fld int32[N //
    8, 8, 128] and src int32[S, 128] into out int32[S + 8, 128]; see
    ``probes_torch.drain``."""
    nrec = q0.shape[0] if isinstance(q0, torch.Tensor) and q0.dim() == 1 else -1
    nsrc = src.shape[0] if isinstance(src, torch.Tensor) and src.dim() == 2 else 0
    if nrec % 8 or nsrc < 1:
        raise TypeError("need q0 int32[N] with N a multiple of 8 and src int32[S, 128] with S >= 1")
    _check("src", src, (nsrc, LANES))
    for name, t, shape in (("q0", q0, (nrec,)), ("r", r, (nrec,)), ("fld", fld, (nrec // 8, 8, LANES))):
        _check(name, t, shape, like=src)
    m = _mode(mode, DRAIN_MODES)
    _knob(knob, nrec)
    if not _on_card(src, cycles, lib):
        return probes_torch.drain(knob, q0, r, fld, src, mode)
    out = torch.empty((nsrc + 8, LANES), dtype=torch.int32, device=src.device)
    fld, src = _aligned16(fld), _aligned16(src)
    _launch("drain", "snappy_probe_drain", src.device, cycles, m, knob, nsrc, q0.data_ptr(), r.data_ptr(),
            fld.data_ptr(), src.data_ptr(), out.data_ptr(), lib=lib)
    return out


def scalar_loop(knob: int, x: torch.Tensor, work: int, unroll: int, cond: bool, chain: bool,
                cycles: torch.Tensor | None = None, lib=None) -> torch.Tensor:
    """P5 on x int32[1024], for one of ``SCALAR_VARIANTS``; see
    ``probes_torch.scalar_loop``."""
    _check("x", x, (1024,))
    if (work, unroll, bool(cond), bool(chain)) not in _SCALAR_VARIANTS:
        raise ValueError(f"no P5 variant work={work} unroll={unroll} cond={cond} chain={chain}")
    _knob(knob, 1 << 30)  # ip stays below 2**31 at the loop's last test
    if not _on_card(x, cycles, lib):
        return probes_torch.scalar_loop(knob, x, work, unroll, cond, chain)
    out = torch.empty(1, dtype=torch.int32, device=x.device)
    _launch("scalar_loop", "snappy_probe_scalar_loop", x.device, cycles, work, unroll, int(cond), int(chain), knob,
            x.data_ptr(), out.data_ptr(), lib=lib)
    return out


def when_drain(knob: int, q: torch.Tensor, r: torch.Tensor, src: torch.Tensor, mode: str,
               cycles: torch.Tensor | None = None, lib=None) -> torch.Tensor:
    """P6 on q, r int32[WHEN_RECORDS] and src int32[WHEN_SRC_ROWS, 128]; see
    ``probes_torch.when_drain``."""
    _check("src", src, (WHEN_SRC_ROWS, LANES))
    _check("q", q, (WHEN_RECORDS,), like=src)
    _check("r", r, (WHEN_RECORDS,), like=src)
    m = _mode(mode, WHEN_MODES)
    _knob(knob, _INT_MAX)
    if not _on_card(src, cycles, lib):
        return probes_torch.when_drain(knob, q, r, src, mode)
    out = torch.empty((WHEN_OUT_ROWS, LANES), dtype=torch.int32, device=src.device)
    _launch("when_drain", "snappy_probe_when_drain", src.device, cycles, m, knob // 8, q.data_ptr(), r.data_ptr(),
            src.data_ptr(), out.data_ptr(), lib=lib)
    return out


READ_TILE = 4096  # words of the one-block read's tiles


def l2_read(x: torch.Tensor, cycles: torch.Tensor | None = None, lib=None) -> torch.Tensor:
    """The XOR of x int32[N], N a multiple of READ_TILE, read by one block
    through a ring of cp.async copies as the drains'; see
    ``probes_torch.xor_words``. Not a probe: its cycles give the rate at which
    one SM takes words in from L2 (``tools/exp_vector_walk.py``)."""
    n = x.shape[0] if isinstance(x, torch.Tensor) and x.dim() == 1 else -1
    if n < 0 or n % READ_TILE:
        raise TypeError(f"x must be int32[N] with N a multiple of {READ_TILE}")
    _check("x", x, (n,))
    if not _on_card(x, cycles, lib):
        return probes_torch.xor_words(x)
    out = torch.empty(1, dtype=torch.int32, device=x.device)
    x = _aligned16(x)
    _launch(None, "snappy_probe_l2_read", x.device, cycles, n // READ_TILE, x.data_ptr(), out.data_ptr(), lib=lib)
    return out
