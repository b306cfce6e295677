"""Plain PyTorch block encoder: the plain version of the CUDA kernel.

The counterpart of ``snappy_tpu/ops/pallas_encode.py`` run with
``contest=False`` (the production setting), byte for byte:
``encode_blocks(blocks, blens, min_profit)`` turns B blocks, uint8[B, W]
with W >= blen + ENC_PAD, into their headerless tag streams,
(out uint8[B, BLOCK_MAX_OUT], olens int32[B]).

For each row, with ``key(p)`` the little-endian 4-byte value at p:

1. Candidates (``candidate_takes``, the counterpart of ``candidate_cmds``).
   A position ``p <= blen - 4`` whose key is not 0xFFFFFFFF gets its two
   most recent earlier positions with the same key, found by a stable sort
   of the keys. Each scores ``m - (2 if p - q < 2048 else 3)``, with ``m``
   4 plus the leading equal bytes of the next four (at most 8; the bytes
   past ``blen`` read as zero). The farther candidate wins ties, and ``p``
   is a take where the better score reaches ``min_profit``.
2. Walk (``_encode_row``). From ``anchor = 0`` and the first take, each take
   ``ip`` with distance ``d`` emits the literal ``[anchor, ip)`` and a copy
   of the common prefix of ``b[ip:]`` and ``b[ip - d:]``, cut at ``blen``;
   the next take is the first at or after the copy's end. A tail literal
   ends the row.
3. Emission follows ``_encode_kernel``'s emitters: literals with 0, 1 or 2
   length bytes; copies as COPY_2 chunks of 64 while 68 or more remain,
   one of 60 above 64, then COPY_1 below length 12 and offset 2048, else
   COPY_2.

The candidate pass runs in torch ops on the input's device; the walk, which
is sequential by nature, runs per row on host ints. ``out`` is zero past
``olens``. A row whose ``blen`` lies outside [0, W - ENC_PAD] comes back
with ``olens = -1`` and all zero, as from the kernel's guard.
``torch.gather`` raises where ``jnp`` clamps, so no index here leaves its
row.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..core.constants import BLOCK_SIZE, max_compressed_length

# Slack past each block, so that the 4-byte loads at p + 4 stay in the row.
ENC_PAD = 8
# Worst-case tag-stream bytes of one 64 KiB block.
BLOCK_MAX_OUT = max_compressed_length(BLOCK_SIZE)
# The key of a position that cannot start a 4-byte group; it pairs with
# nothing, so a real ff ff ff ff group never matches either.
SENTINEL = 0xFFFFFFFF
# Match lengths from the candidate pass are exact below this; the walk
# extends the rest.
M_CAP = 8
# A copy offset must fit 16 bits.
MAX_DISTANCE = 1 << 16
# Offsets below this take a 2-byte copy tag where the length allows.
COPY1_MAX_DISTANCE = 2048

_I64 = torch.int64


def _words(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Little-endian 4-byte value of x[..., start + p : start + p + 4] for
    p in [0, n); x is int64."""
    return x[..., start : start + n] | (x[..., start + 1 : start + 1 + n] << 8) | (
        x[..., start + 2 : start + 2 + n] << 16
    ) | (x[..., start + 3 : start + 3 + n] << 24)


def _equal_leading_bytes(x: torch.Tensor) -> torch.Tensor:
    """Count of zero low-order bytes of the xor of two LE32 words (0..4)."""
    return torch.where(
        (x & 0xFF) != 0,
        0,
        torch.where((x & 0xFFFF) != 0, 1, torch.where((x & 0xFFFFFF) != 0, 2, torch.where(x != 0, 3, 4))),
    )


def candidate_takes(rows: torch.Tensor, blens: torch.Tensor, min_profit: int):
    """The take of every position: (d int64[B, n], m int64[B, n]), with
    n = W - ENC_PAD, d the chosen candidate's distance (0 where p is no
    take) and m its match length from the candidate pass (4..8, where 8
    means at least 8). ``rows`` must be zero past each blen."""
    b, w = rows.shape
    n = w - ENC_PAD
    dev = rows.device
    x = rows.to(_I64)
    key = _words(x, 0, n)
    w1 = _words(x, 4, n)
    pos = torch.arange(n, dtype=_I64, device=dev)[None, :]
    key = torch.where(pos <= blens.to(_I64)[:, None] - 4, key, SENTINEL)
    # Stable: equal keys keep ascending position order, so the ranks just
    # below a position's are its most recent earlier occurrences.
    sv, sp = torch.sort(key, dim=-1, stable=True)
    sw = torch.gather(w1, -1, sp)

    def candidate(k: int):
        """(m, d, profit) of the k-th most recent earlier equal key."""
        same = torch.zeros((b, n), dtype=torch.bool, device=dev)
        dist = torch.zeros((b, n), dtype=_I64, device=dev)
        xor = torch.zeros((b, n), dtype=_I64, device=dev)
        same[:, k:] = (sv[:, k:] == sv[:, :-k]) & (sv[:, k:] != SENTINEL)
        dist[:, k:] = sp[:, k:] - sp[:, :-k]
        xor[:, k:] = sw[:, k:] ^ sw[:, :-k]
        ok = same & (dist < MAX_DISTANCE)
        m = torch.where(ok, 4 + _equal_leading_bytes(xor), 0)
        d = torch.where(ok, dist, 0)
        profit = torch.where(ok, m - torch.where(d < COPY1_MAX_DISTANCE, 2, 3), -1)
        return m, d, profit

    m1, d1, p1 = candidate(1)
    m2, d2, p2 = candidate(2)
    # Ties go to the farther candidate.
    use2 = (p2 >= p1) & (m2 > 0)
    m = torch.where(use2, m2, m1)
    take = (torch.maximum(p1, p2) >= min_profit) & (m >= 4)
    d = torch.where(take, torch.where(use2, d2, d1), 0)
    m = torch.where(take, m, 0)
    # Back to position order.
    return torch.zeros_like(d).scatter_(-1, sp, d), torch.zeros_like(m).scatter_(-1, sp, m)


def _match_length(data: bytes, a: int, b: int, start: int, limit: int) -> int:
    """Length of the common prefix of data[a:] and data[b:], given that the
    first ``start`` bytes agree, cut at ``limit``."""
    m, step = start, 16
    while m < limit:
        k = min(step, limit - m)
        sa, sb = data[a + m : a + m + k], data[b + m : b + m + k]
        if sa != sb:
            return m + next(i for i in range(k) if sa[i] != sb[i])
        m += k
        step = min(step * 2, 4096)
    return limit


def _emit_literal(out: bytearray, data: bytes, start: int, end: int) -> None:
    n = end - start
    if n <= 0:
        return
    nm1 = n - 1
    if nm1 < 60:
        out.append(nm1 << 2)
    elif nm1 < 256:
        out += bytes((60 << 2, nm1))
    else:
        out += bytes((61 << 2, nm1 & 0xFF, nm1 >> 8))
    out += data[start:end]


def _emit_copy(out: bytearray, d: int, m: int) -> None:
    lo, hi = d & 0xFF, d >> 8
    while m >= 68:
        out += bytes((0x02 | (63 << 2), lo, hi))
        m -= 64
    if m > 64:
        out += bytes((0x02 | (59 << 2), lo, hi))
        m -= 60
    if m < 12 and d < COPY1_MAX_DISTANCE:
        out += bytes((0x01 | ((m - 4) << 2) | (hi << 5), lo))
    else:
        out += bytes((0x02 | ((m - 1) << 2), lo, hi))


def _encode_row(data: bytes, blen: int, d_row: np.ndarray, m_row: np.ndarray) -> bytearray:
    """The walk and emission of one row, whose takes are given."""
    out = bytearray()
    takes = np.flatnonzero(d_row[: max(blen - 3, 0)]).tolist()
    anchor, i = 0, 0
    while i < len(takes):
        ip = takes[i]
        d, m = int(d_row[ip]), int(m_row[ip])
        limit = blen - ip
        m = _match_length(data, ip, ip - d, M_CAP, limit) if m >= M_CAP else min(m, limit)
        _emit_literal(out, data, anchor, ip)
        _emit_copy(out, d, m)
        anchor = ip + m
        i = bisect.bisect_left(takes, anchor, i + 1)
    _emit_literal(out, data, anchor, blen)
    return out


def encode_blocks(blocks: torch.Tensor, blens: torch.Tensor, min_profit: int):
    """Encode B blocks into headerless tag streams; see the module
    docstring. Returns (out uint8[B, BLOCK_MAX_OUT], olens int32[B]) on the
    input's device."""
    b, w = blocks.shape
    n = w - ENC_PAD
    dev = blocks.device
    blens64 = blens.to(_I64)
    fits = (blens64 >= 0) & (blens64 <= n)
    blens64 = torch.where(fits, blens64, 0)
    col = torch.arange(w, dtype=_I64, device=dev)[None, :]
    rows = torch.where(col < blens64[:, None], blocks, 0)
    d, m = candidate_takes(rows, blens64, min_profit)
    rows_np, blens_np, fits_np = rows.cpu().numpy(), blens64.cpu().numpy(), fits.cpu().numpy()
    d_np, m_np = d.cpu().numpy(), m.cpu().numpy()
    out = np.zeros((b, BLOCK_MAX_OUT), np.uint8)
    olens = np.full(b, -1, np.int32)
    for r in range(b):
        if not fits_np[r]:
            continue
        blen = int(blens_np[r])
        stream = _encode_row(rows_np[r, :blen].tobytes(), blen, d_np[r], m_np[r])
        out[r, : len(stream)] = np.frombuffer(stream, np.uint8)
        olens[r] = len(stream)
    return torch.from_numpy(out).to(dev), torch.from_numpy(olens).to(dev)
