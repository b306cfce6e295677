"""The plain reference of ``parallel/distributed.py::compress_streams``.

Plain torch, on any device, that imports no kernel and nothing else of the
port: each page is encoded alone, with no batching and no fragment table,
into a raw Snappy stream (google/snappy's ``format_description.txt``): the
page's length as a varint, then the stream of each 64 KiB fragment of the
page in turn (libsnappy's ``kBlockSize``), each fragment parsed on its own
by the three rules of the block encoder K2:

1. Candidates. A position p of the fragment, p <= len - 4, whose four bytes
   read as a little-endian key other than 0xFFFFFFFF, has as candidates its
   two most recent earlier positions with the same key. A candidate q
   matches ``m`` bytes: 4, plus the leading equal bytes of the four after
   p and q (bytes past the fragment's end read as zero); it scores ``m``
   less its copy tag's bytes, 2 where p - q < 2048, else 3. The better
   score wins, the farther candidate on a tie, and p is a take where that
   score reaches ``min_profit``.
2. Walk. From the fragment's start, the first take ip with distance d emits
   the literal since the last copy's end and a copy of the common prefix
   of the bytes at ip and at ip - d, cut at the fragment's end; the next
   take is the first at or after the copy's end. A literal of what is left
   ends the fragment.
3. Emission. A literal of n bytes: its tag holds n - 1 where n - 1 < 60,
   else 60 or 61 with n - 1 in one or two bytes after it, then the bytes.
   A copy of m bytes: COPY_2 tags of 64 while 68 or more remain, one of 60
   where more than 64 remain, then a COPY_1 where fewer than 12 remain and
   d < 2048, else a COPY_2.
"""

from __future__ import annotations

import bisect

import torch

FRAGMENT = 1 << 16
NO_KEY = 0xFFFFFFFF
NEAR = 2048


def varint(n: int) -> bytes:
    """The varint of ``n``: seven bits a byte, low first."""
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _takes(frag: torch.Tensor, min_profit: int) -> dict[int, int]:
    """Rule 1: each take of the fragment (uint8[n]) and its distance."""
    n = frag.shape[0]
    if n < 4:
        return {}
    x = torch.nn.functional.pad(frag, (0, 8)).long()
    keys = x[: n - 3] | x[1 : n - 2] << 8 | x[2 : n - 1] << 16 | x[3:n] << 24
    after = x[4 : n + 1] | x[5 : n + 2] << 8 | x[6 : n + 3] << 16 | x[7 : n + 4] << 24
    pos = torch.arange(n - 3, device=frag.device)
    valid = keys != NO_KEY
    # Positions grouped by key, ascending within a group: each one's
    # predecessors in its group are its most recent earlier equal keys.
    _, group = torch.unique(torch.where(valid, keys, -1), return_inverse=True)
    order = torch.argsort(group * (n + 1) + pos)
    g, p = group[order], pos[order]

    def candidate(back: int):
        q = torch.full_like(p, -1)
        if len(p) > back:
            q[back:] = torch.where((g[back:] == g[:-back]) & valid[p[back:]], p[:-back], -1)
        diff = after[p] ^ after[q.clamp(min=0)]
        lead = torch.zeros_like(diff)
        for k in range(4):
            lead += ((diff & ((1 << (8 * (k + 1))) - 1)) == 0).long()
        m = 4 + lead
        score = torch.where(q >= 0, m - torch.where(p - q < NEAR, 2, 3), -1)
        return q, score

    q1, s1 = candidate(1)
    q2, s2 = candidate(2)
    far = (q2 >= 0) & (s2 >= s1)
    q = torch.where(far, q2, q1)
    take = (torch.maximum(s1, s2) >= min_profit) & (q >= 0)
    return dict(zip(p[take].tolist(), (p - q)[take].tolist()))


def _literal(out: bytearray, data: bytes) -> None:
    n = len(data)
    if n == 0:
        return
    if n - 1 < 60:
        out.append((n - 1) << 2)
    elif n - 1 < 256:
        out += bytes((60 << 2, n - 1))
    else:
        out += bytes((61 << 2, (n - 1) & 0xFF, (n - 1) >> 8))
    out += data


def _copy(out: bytearray, d: int, m: int) -> None:
    def copy2(length: int) -> None:
        out.extend((2 | (length - 1) << 2, d & 0xFF, d >> 8))

    while m >= 68:
        copy2(64)
        m -= 64
    if m > 64:
        copy2(60)
        m -= 60
    if m < 12 and d < NEAR:
        out.extend((1 | (m - 4) << 2 | (d >> 8) << 5, d & 0xFF))
    else:
        copy2(m)


def compress_fragment(frag: torch.Tensor, min_profit: int = 2) -> bytes:
    """The headerless stream of one fragment (uint8[n], n <= 65536), by
    rules 2 and 3 over rule 1's takes."""
    takes = _takes(frag, min_profit)
    data = bytes(frag.cpu().tolist())
    order = sorted(takes)
    out = bytearray()
    anchor, i = 0, 0
    while i < len(order):
        ip = order[i]
        d = takes[ip]
        m = 0
        while ip + m < len(data) and data[ip + m] == data[ip - d + m]:
            m += 1
        _literal(out, data[anchor:ip])
        _copy(out, d, m)
        anchor = ip + m
        i = bisect.bisect_left(order, anchor, i + 1)
    _literal(out, data[anchor:])
    return bytes(out)


def compress_page(page: torch.Tensor, min_profit: int = 2) -> bytes:
    """The raw stream of one page (uint8[n]): its varint, then each 64 KiB
    fragment's stream in turn."""
    n = page.shape[0]
    return varint(n) + b"".join(compress_fragment(page[lo : lo + FRAGMENT], min_profit)
                                for lo in range(0, n, FRAGMENT))


def compress_streams(data: torch.Tensor, starts, ulens, min_profit: int = 2):
    """(comp uint8[sum of the streams], cstarts int64[n], clens int32[n]) on
    ``data``'s device: each page encoded alone, the streams end to end in
    page order; a page that does not lie in ``data`` or has a negative
    length takes no bytes and has clens -1. The arguments are
    ``compress_streams``'s."""
    streams, cstarts, clens, at = [], [], [], 0
    for start, ulen in zip(torch.as_tensor(starts).tolist(), torch.as_tensor(ulens).tolist()):
        cstarts.append(at)
        if not (ulen >= 0 and 0 <= start <= data.numel() - ulen):
            clens.append(-1)
            continue
        s = compress_page(data[start : start + ulen], min_profit)
        streams.append(s)
        clens.append(len(s))
        at += len(s)
    comp = torch.tensor(list(b"".join(streams)), dtype=torch.uint8, device=data.device)
    return comp, torch.tensor(cstarts, dtype=torch.int64), torch.tensor(clens, dtype=torch.int32)
