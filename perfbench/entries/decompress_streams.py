"""Decode cells of raw streams: the program's batched raw-stream decoder
with a file's row groups resident.

Set-up puts each row group the generator made (its column chunks: page
headers and Snappy streams, as a file holds them) on the device, with its
streams' offsets, lengths, stated sizes and output offsets. A call decodes
one row group through ``snappy_tpu_torch.parallel.distributed.
decompress_streams``: every page of it in one call, into one output.

Judged: every page ok and its bytes the page's, against the pages the seed
made. The control is the plain reference decoder with copies moved as one
block (``reference.decode_raw(..., overlap=False)``, each page's header read
and its body decoded, the bodies batched by width on the device) in the
program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import reference

DIRECTION = "decode"
# Pages the control decodes at once: of like width, their bytes near 2**28.
CONTROL_BYTES = 1 << 28


@dataclass
class Group:
    """A resident row group."""

    comp: torch.Tensor  # u8 on the device: the column chunks
    starts: torch.Tensor  # i64[p]: each page's stream
    clens: torch.Tensor  # i32[p]
    ulens: torch.Tensor  # i32[p]
    out_starts: torch.Tensor  # i64[p]
    out_len: int
    pages: np.ndarray  # u8[out_len] on the host: the pages as the seed made them
    host: dict  # the offsets and lengths above as numpy arrays, and the row group's bytes


@dataclass
class State:
    device: torch.device
    groups: list

    @property
    def rows(self) -> int:
        return len(self.groups[0].host["starts"])


def prepare(groups, config: dict, cell: dict, device: torch.device) -> State:
    from snappy_tpu_torch.parallel.distributed import decompress_streams  # noqa: F401 (the program has it)

    resident = []
    for g in groups:
        host = {"data": g.data, "starts": g.starts, "clens": g.clens, "ulens": g.ulens, "out_starts": g.out_starts}
        resident.append(Group(
            comp=torch.from_numpy(g.data.copy()).to(device), starts=torch.from_numpy(g.starts).to(device),
            clens=torch.from_numpy(g.clens).to(device), ulens=torch.from_numpy(g.ulens).to(device),
            out_starts=torch.from_numpy(g.out_starts).to(device), out_len=g.out_len, pages=g.pages, host=host,
        ))
    return State(device=device, groups=resident)


def batches(state: State) -> int:
    return len(state.groups)


def call(state: State, b: int):
    """One row group through the program: (out, ok)."""
    from snappy_tpu_torch.parallel import distributed

    g = state.groups[b]
    return distributed.decompress_streams(g.comp, g.starts, g.clens, g.ulens, g.out_starts, g.out_len)


def _header(stream: np.ndarray) -> tuple[int, int] | None:
    """(length, header bytes) of a varint32 at the start of ``stream``."""
    n = 0
    for i in range(min(5, len(stream))):
        n |= (int(stream[i]) & 0x7F) << (7 * i)
        if stream[i] < 0x80:
            return (n, i + 1) if n < 1 << 32 else None
    return None


def control(state: State, b: int):
    """One row group through the control in the program's place: (out, ok)."""
    g = state.groups[b]
    h = g.host
    out = torch.zeros(g.out_len, dtype=torch.uint8, device=state.device)
    ok = torch.zeros(len(h["starts"]), dtype=torch.bool, device=state.device)
    bodies, wanted, pages = [], [], []
    for i, (s, c, u) in enumerate(zip(h["starts"].tolist(), h["clens"].tolist(), h["ulens"].tolist())):
        stream = h["data"][s : s + c]
        head = _header(stream)
        if head is not None and head[0] == u:
            bodies.append(stream[head[1] :])
            wanted.append(u)
            pages.append(i)
    order = np.argsort([len(x) for x in bodies], kind="stable")
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while hi < len(order) and (hi - lo + 1) * max(len(bodies[order[hi]]), wanted[order[hi]], 1) <= CONTROL_BYTES:
            hi += 1
        part = order[lo:hi]
        width = max(len(bodies[i]) for i in part) + 4
        rows = np.zeros((len(part), width), np.uint8)
        for r, i in enumerate(part):
            rows[r, : len(bodies[i])] = bodies[i]
        clens = torch.tensor([len(bodies[i]) for i in part], device=state.device)
        ulens = torch.tensor([wanted[i] for i in part], device=state.device)
        dec, good = reference.decode_rows(torch.from_numpy(rows).to(state.device), clens, ulens,
                                          max(int(ulens.max()), 1), overlap=False)
        for r, i in enumerate(part):
            page, n = pages[i], wanted[i]
            if bool(good[r]):
                o0 = int(h["out_starts"][page])
                out[o0 : o0 + n] = dec[r, :n]
                ok[page] = True
        lo = hi
    return out, ok


def work(state: State, b: int, result) -> dict:
    """What batch ``b`` moved: pages, uncompressed bytes, stream bytes."""
    h = state.groups[b].host
    return {"rows": len(h["starts"]), "bytes": int(h["ulens"].sum(dtype=np.int64)),
            "comp_bytes": int(h["clens"].sum(dtype=np.int64))}


def wrong_rows(state: State, b: int, result) -> int:
    """Pages of batch ``b`` that the result gets wrong: not ok, or not the
    page's bytes."""
    out, ok = result
    g = state.groups[b]
    h = g.host
    if tuple(out.shape) != (g.out_len,) or tuple(ok.shape) != (len(h["starts"]),):
        return len(h["starts"])
    got, good = out.cpu().numpy(), ok.cpu().numpy()
    wrong = 0
    for i, (o0, n) in enumerate(zip(h["out_starts"].tolist(), h["ulens"].tolist())):
        wrong += not good[i] or not np.array_equal(got[o0 : o0 + n], g.pages[o0 : o0 + n])
    return wrong
