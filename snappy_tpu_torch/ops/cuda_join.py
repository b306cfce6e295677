"""Stream join on the card (K5): the wrapper of ``csrc/join_streams.cu``, its
plain version, and the fragment table that K2 and K5 read.

A raw Snappy stream is the varint of its length, then the headerless stream
of each 64 KiB fragment of its bytes in turn (libsnappy's ``kBlockSize``).
``parallel/distributed.py::compress_streams`` encodes many pages at once:

- ``fragment_table(starts, ulens, data_len)`` cuts each page into its
  fragments with torch ops on the pages' device, no value read on the host:
  a table of ``capacity(n, data_len)`` fragments (each page's in page
  order, empty rows after the last), the rows of K2's two launches (the
  fragments over 32 KiB in a launch of the 64 KiB variant, the others in
  one of the 32 KiB variant, two blocks an SM: K2's rules do not depend on
  the row width, so each gives the same bytes) and each fragment's row
  among them, and each page's first fragment and fragment count. A page
  with a negative length, or whose bytes do not lie in ``data_len``, is
  refused (count -1), as is one whose fragments would pass the table,
  which only pages that overlap can reach;
- ``join_streams(frags, olens, frow, ffirst, fcount, ulens, cap)`` writes
  each page's header and its fragments' streams behind it, the pages' streams
  end to end in page order in ``comp`` (uint8[cap]), and returns
  ``(comp, cstarts int64[n], clens int32[n])``. ``clens`` is -1 for a
  refused page, one with a fragment K2 refused, or one whose stream would
  pass ``cap``; such a page writes nothing outside the bytes its fragments
  take. A CUDA buffer launches K5 on the current stream and returns
  without synchronising; a CPU buffer runs ``join_streams_plain``.

The span is ``k5.join_streams`` with the launch in ``k5.launch``; a launch
counts under ``k5.launches``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np
import torch

from ..utils.profiling import count, trace_annotation
from . import kernels

FRAGMENT = 1 << 16  # libsnappy's kBlockSize: a raw stream's fragments are parsed alone
NARROW = 1 << 15  # fragments up to this take K2's 32 KiB variant


def capacity(n: int, data_len: int) -> int:
    """Fragments enough for n pages that lie apart in ``data_len`` bytes:
    each holds at most one that is not full."""
    return data_len // FRAGMENT + n


def header_bytes(ulens: torch.Tensor) -> torch.Tensor:
    """Bytes of the varint of each of ``ulens`` (at least 0)."""
    u = ulens.long()
    return 1 + (u >= 1 << 7).long() + (u >= 1 << 14).long() + (u >= 1 << 21).long() + (u >= 1 << 28).long()


def stream_bound(n: int, data_len: int) -> int:
    """The most bytes n pages' streams take when the pages lie apart in
    ``data_len`` bytes: a fragment of f bytes at most 32 + f + f // 6, a
    header at most 5."""
    return data_len + data_len // 6 + 32 * capacity(n, data_len) + 5 * n


@dataclasses.dataclass
class Fragments:
    """A call's fragment table, on the pages' device."""

    frow: torch.Tensor  # i32[F]: its row in K2's output, the wide launch's rows first
    ffirst: torch.Tensor  # i64[n]: each page's first fragment
    fcount: torch.Tensor  # i32[n]: its fragments, -1 for a refused page
    wide: tuple  # (fstarts, flens) of the 64 KiB variant's launch, [F]
    narrow: tuple  # (fstarts, flens) of the 32 KiB variant's launch, [min(n, F)]
    total: torch.Tensor  # i64[1]: the fragments the table holds


def _compact(values: torch.Tensor, pick: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The values where ``pick`` holds, in order, in ``rows`` slots (zero
    after them), and each one's slot; by a scatter, with no host read."""
    slot = torch.cumsum(pick, 0) - pick.long()
    dest = torch.where(pick, slot, rows)
    out = torch.zeros(rows + 1, dtype=values.dtype, device=values.device)
    return out.scatter_(0, dest, values)[:rows], slot


def fragment_table(starts: torch.Tensor, ulens: torch.Tensor, data_len: int) -> Fragments:
    """The fragments of the pages ``starts`` (int64[n]), ``ulens``
    (int32[n]) of a buffer of ``data_len`` bytes; see the module docstring."""
    n, dev = starts.shape[0], starts.device
    if n == 0:
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return Fragments(none.int(), none, none.int(), (none, none.int()), (none, none.int()),
                         torch.zeros(1, dtype=torch.int64, device=dev))
    cap = capacity(n, data_len)
    u = ulens.long()
    fits = (u >= 0) & (starts >= 0) & (starts <= data_len - u)
    k = torch.where(fits, (u + FRAGMENT - 1) // FRAGMENT, 0)
    fits &= torch.cumsum(k, 0) <= cap
    k = torch.where(fits, k, 0)
    end = torch.cumsum(k, 0)
    ffirst = end - k
    f = torch.arange(cap, device=dev)
    page = torch.searchsorted(end, f, right=True)
    real = page < n
    page = page.clamp(max=n - 1)
    j = f - ffirst[page]
    fstarts = torch.where(real, starts[page] + j * FRAGMENT, 0)
    flens = torch.where(real, (u[page] - j * FRAGMENT).clamp(max=FRAGMENT), 0).int()
    wide = real & (flens > NARROW)
    narrow = real & ~wide
    n_rows = min(n, cap)
    w_starts, w_slot = _compact(fstarts, wide, cap)
    w_lens, _ = _compact(flens, wide, cap)
    n_starts, n_slot = _compact(fstarts, narrow, n_rows)
    n_lens, _ = _compact(flens, narrow, n_rows)
    frow = torch.where(wide, w_slot, cap + n_slot).int()
    return Fragments(frow, ffirst, torch.where(fits, k, -1).int(), (w_starts, w_lens), (n_starts, n_lens), end[-1:])


def join_streams(frags, olens, frow, ffirst, fcount, ulens, cap: int):
    """Join each page's header and its fragments' streams; see the module
    docstring. ``frags`` is uint8[R, W] and ``olens`` int32[R], K2's rows;
    ``frow`` int32[F], ``ffirst`` int64[n], ``fcount`` and ``ulens``
    int32[n], ``fragment_table``'s."""
    with trace_annotation("k5.join_streams"):
        n = _check_args(frags, olens, frow, ffirst, fcount, ulens, cap)
        dev = frags.device
        cstarts = torch.empty(n, dtype=torch.int64, device=dev)
        clens = torch.empty(n, dtype=torch.int32, device=dev)
        if dev.type == "cpu":
            comp = torch.zeros(cap, dtype=torch.uint8)
            join_streams_plain(frags, olens, frow, ffirst, fcount, ulens, comp, cstarts, clens)
            return comp, cstarts, clens
        if dev.type != "cuda":
            raise ValueError(f"no stream join for device {dev}")
        comp = torch.empty(cap, dtype=torch.uint8, device=dev)
        if n == 0:
            return comp, cstarts, clens
        fn = kernels.load("join_streams").snappy_cuda_join_streams
        with torch.cuda.device(dev), trace_annotation("k5.launch"):
            rc = fn(frags.data_ptr(), frags.shape[1], olens.data_ptr(), frow.data_ptr(), ffirst.data_ptr(),
                    fcount.data_ptr(), ulens.data_ptr(), n, frow.shape[0], comp.data_ptr(), cap,
                    cstarts.data_ptr(), clens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(rc, "join_streams launch")
        count("k5.launches")
        return comp, cstarts, clens


def _check_args(frags, olens, frow, ffirst, fcount, ulens, cap: int) -> int:
    if frags.dtype != torch.uint8 or frags.dim() != 2:
        raise TypeError(f"frags must be uint8[R, W], got {frags.dtype}{list(frags.shape)}")
    n = ffirst.shape[0] if ffirst.dim() == 1 else -1
    for name, t, dtype, shape in (("olens", olens, torch.int32, (frags.shape[0],)),
                                  ("frow", frow, torch.int32, (frow.shape[0],) if frow.dim() == 1 else None),
                                  ("ffirst", ffirst, torch.int64, (n,)), ("fcount", fcount, torch.int32, (n,)),
                                  ("ulens", ulens, torch.int32, (n,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be {dtype}{list(shape or [-1])}, got {t.dtype}{list(t.shape)}")
    for t in (frags, olens, frow, ffirst, fcount, ulens):
        if t.device != frags.device or not t.is_contiguous():
            raise ValueError("the rows, the tables and the lengths must be contiguous on one device")
    if cap < 0:
        raise ValueError("cap must be >= 0")
    return n


def join_streams_plain(frags, olens, frow, ffirst, fcount, ulens, comp, cstarts, clens) -> None:
    """The plain version of K5 on CPU tensors, into ``comp``, ``cstarts``
    and ``clens``: the same bytes where the kernel writes, nothing
    elsewhere."""
    cap = comp.numel()
    rows, olens, frow = frags.numpy(), olens.numpy().astype(np.int64), frow.numpy().astype(np.int64)
    ffirst, fcount, ulens = ffirst.numpy(), fcount.numpy().astype(np.int64), ulens.numpy().astype(np.int64)
    heads = np.where(fcount >= 0, header_bytes(torch.from_numpy(ulens)).numpy(), 0)
    buf, starts, lens = comp.numpy(), cstarts.numpy(), clens.numpy()
    at = 0
    for p in range(len(ffirst)):
        frag = range(int(ffirst[p]), int(ffirst[p]) + max(int(fcount[p]), 0))
        m = [int(olens[frow[g]]) for g in frag]
        total = int(heads[p]) + sum(max(x, 0) for x in m)
        starts[p] = at
        lens[p] = total if fcount[p] >= 0 and min(m, default=0) >= 0 and at + total <= cap else -1
        if fcount[p] >= 0 and at + heads[p] <= cap:
            v = int(ulens[p])
            for j in range(int(heads[p])):
                buf[at + j] = (v & 0x7F) | (0x80 if j + 1 < heads[p] else 0)
                v >>= 7
        at += int(heads[p])
        for g, x in zip(frag, m):
            x = max(x, 0)
            if at + x <= cap:
                buf[at : at + x] = rows[frow[g], :x]
            at += x


# The card's fragment counts on their way to the host: (event, pinned i64[2]).
_pending: collections.deque = collections.deque()
_pending_lock = threading.Lock()


def count_call(n: int, fragments: torch.Tensor) -> None:
    """Count a call's pages under ``streams.enc_streams`` and the fragments
    it sent to K2 (``fragments``, int64[1] on its device) under
    ``streams.enc_fragments``: on the CPU at once, on a card once a small
    copy behind the call has landed, at a later call (none waits for it)."""
    if fragments.device.type != "cuda":
        count("streams.enc_streams", n)
        count("streams.enc_fragments", int(fragments[0]))
        return
    with _pending_lock:
        while _pending and _pending[0][0].query():
            _, host = _pending.popleft()
            count("streams.enc_streams", int(host[0]))
            count("streams.enc_fragments", int(host[1]))
    with torch.cuda.device(fragments.device):
        host = torch.empty(2, dtype=torch.int64, pin_memory=True)
        host[0] = n
        host[1:].copy_(fragments, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    with _pending_lock:
        _pending.append((event, host))
