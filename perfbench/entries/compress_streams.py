"""Encode cells of raw streams: the program's batched raw-stream encoder with
a file's row groups resident as a writer holds them before compression.

Set-up puts each row group's pages on the device as they lie end to end in
one buffer, each at the generator's 16-byte-aligned output offset, with
their offsets and lengths. A call compresses every page of one row group
through ``snappy_tpu_torch.parallel.distributed.compress_streams``: one raw
Snappy stream a page, the streams end to end in one output, returned as
(comp, cstarts, clens).

Judged: each page's stream must be accepted (clens >= 0) and lie in the
output, carry the page's length as its varint header, be no longer than
``max_compressed_length(u)`` plus that header, and decode under the plain
reference decoder (``perfbench/reference.py``; the bodies batched by width
on the device) to exactly the page's bytes. The control is the frozen
encoder with its candidate check removed (``encoder.compress_rows(...,
control=True)``, each 64 KiB fragment of each page) in the program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import encoder, reference

DIRECTION = "encode"
FRAGMENT = 1 << 16  # a raw stream's fragments, as libsnappy parses them
# Bodies the judge decodes at once: of like width, their bytes near 2**28.
JUDGE_BYTES = 1 << 28


@dataclass
class Group:
    """A resident row group's pages."""

    data: torch.Tensor  # u8 on the device: the pages end to end
    starts: torch.Tensor  # i64[p]: each page's offset in data
    ulens: torch.Tensor  # i32[p]: its length
    pages: np.ndarray  # u8 on the host: data as the seed made it
    host: dict  # starts and ulens as numpy arrays


@dataclass
class State:
    device: torch.device
    groups: list

    @property
    def rows(self) -> int:
        return len(self.groups[0].host["starts"])


def prepare(groups, config: dict, cell: dict, device: torch.device) -> State:
    from snappy_tpu_torch.parallel.distributed import compress_streams  # noqa: F401 (the program has it)

    resident = []
    for g in groups:
        resident.append(Group(
            data=torch.from_numpy(g.pages.copy()).to(device), starts=torch.from_numpy(g.out_starts).to(device),
            ulens=torch.from_numpy(g.ulens).to(device), pages=g.pages,
            host={"starts": g.out_starts, "ulens": g.ulens},
        ))
    return State(device=device, groups=resident)


def batches(state: State) -> int:
    return len(state.groups)


def call(state: State, b: int):
    """One row group through the program: (comp, cstarts, clens)."""
    from snappy_tpu_torch.parallel import distributed

    g = state.groups[b]
    return distributed.compress_streams(g.data, g.starts, g.ulens)


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def control(state: State, b: int):
    """One row group through the control in the program's place."""
    g = state.groups[b]
    h = g.host
    frags, lens, owner = [], [], []
    for i, (s, u) in enumerate(zip(h["starts"].tolist(), h["ulens"].tolist())):
        for lo in range(0, u, FRAGMENT):
            frags.append(g.pages[s + lo : s + min(u, lo + FRAGMENT)])
            lens.append(len(frags[-1]))
            owner.append(i)
    blocks = np.zeros((len(frags), FRAGMENT), np.uint8)
    for k, f in enumerate(frags):
        blocks[k, : len(f)] = f
    width = -(-encoder.max_compressed_length(FRAGMENT) // 16) * 16
    out, olens = encoder.compress_rows(blocks, np.asarray(lens, np.int32), width, control=True)
    parts = [[varint(u)] for u in h["ulens"].tolist()]
    for k, i in enumerate(owner):
        parts[i].append(out[k, : olens[k]].tobytes())
    streams = [b"".join(p) for p in parts]
    clens = np.array([len(s) for s in streams], np.int32)
    cstarts = np.cumsum(clens, dtype=np.int64) - clens
    comp = np.frombuffer(b"".join(streams), np.uint8).copy()
    return tuple(torch.from_numpy(a).to(state.device) for a in (comp, cstarts, clens))


def work(state: State, b: int, result) -> dict:
    """What batch ``b`` moved: pages, their bytes, and the streams' bytes
    (headers included), the result's lengths summed once the window has
    closed."""
    h = state.groups[b].host
    return {"rows": len(h["starts"]), "bytes": int(h["ulens"].sum(dtype=np.int64)), "comp_bytes": result[2]}


def _header(stream: np.ndarray) -> tuple[int, int] | None:
    """(value, bytes) of the varint32 at the start of ``stream``."""
    n = 0
    for i in range(min(5, len(stream))):
        n |= (int(stream[i]) & 0x7F) << (7 * i)
        if stream[i] < 0x80:
            return (n, i + 1) if n < 1 << 32 else None
    return None


def wrong_rows(state: State, b: int, result) -> int:
    """Pages of batch ``b`` whose stream is refused or out of the output,
    has another length in its header, is longer than the bound, or does
    not decode to the page's bytes."""
    comp, cstarts, clens = result
    g = state.groups[b]
    h = g.host
    n = len(h["starts"])
    if comp.dim() != 1 or tuple(cstarts.shape) != (n,) or tuple(clens.shape) != (n,):
        return n
    buf, starts, lens = comp.cpu().numpy(), cstarts.cpu().numpy(), clens.cpu().numpy()
    wrong = 0
    bodies, wanted, pages = [], [], []
    for i, (s, c, o, u) in enumerate(zip(starts.tolist(), lens.tolist(), h["starts"].tolist(), h["ulens"].tolist())):
        head = _header(buf[s : s + c]) if 0 <= c and 0 <= s <= len(buf) - c else None
        if head is None or head[0] != u or c > encoder.max_compressed_length(u) + head[1]:
            wrong += 1
            continue
        bodies.append(buf[s + head[1] : s + c])
        wanted.append(u)
        pages.append(o)
    order = np.argsort([max(len(x), u) for x, u in zip(bodies, wanted)], kind="stable")
    lo = 0
    while lo < len(order):
        hi = lo + 1
        while hi < len(order) and (hi - lo + 1) * max(len(bodies[order[hi]]), wanted[order[hi]], 1) <= JUDGE_BYTES:
            hi += 1
        part = order[lo:hi]
        width = max(len(bodies[i]) for i in part) + 4
        rows = np.zeros((len(part), width), np.uint8)
        for r, i in enumerate(part):
            rows[r, : len(bodies[i])] = bodies[i]
        clen = torch.tensor([len(bodies[i]) for i in part], device=state.device)
        ulen = torch.tensor([wanted[i] for i in part], device=state.device)
        size = max(int(ulen.max()), 1)
        dec, ok = reference.decode_rows(torch.from_numpy(rows).to(state.device), clen, ulen, size)
        want = np.zeros((len(part), size), np.uint8)
        for r, i in enumerate(part):
            want[r, : wanted[i]] = g.pages[pages[i] : pages[i] + wanted[i]]
        bad = ~ok | (dec != torch.from_numpy(want).to(state.device)).any(dim=1)
        wrong += int(bad.sum())
        lo = hi
    return wrong
