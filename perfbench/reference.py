"""The plain reference: a Snappy block decoder in plain PyTorch.

It imports nothing of the program and takes nothing the program made but
the streams it judges. It follows the format description of google/snappy
(``format_description.txt``): a stream is a sequence of tags; a literal tag
(kind 0) carries its length in its upper six bits, or in the 1 to 4 bytes
after it when those bits are 60 to 63, and then its bytes; a copy tag (kind
1, 2 or 4-byte offsets for kinds 1, 2 and 3) repeats ``length`` bytes from
``offset`` bytes back in the output, one byte at a time, so a copy may read
its own output (``offset < length`` repeats a pattern).

It decodes a batch of rows at once, on any device, with no loop over tags:

1. every position of a row is read as if a tag started there, which gives
   the position of the next tag;
2. the tags of each row are the positions reached from 0 by that map,
   found by doubling it (``log2`` of the tag count gathers);
3. each output byte is then either a literal byte of the row or a
   reference to an earlier output byte, and references are followed by
   pointer jumping until every byte holds a literal's value.

A row is refused (``ok`` false, its output zero) where a tag runs past the
row's length, a copy's offset is 0 or reaches before the row's first byte,
or the decoded length differs from the one expected.

``overlap=False`` is the control: a decoder that moves each copy as one
block, reading the row as it was before the copy, as a wide ``memmove``
would. Where a copy reads its own output the bytes it reads are still zero.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows a pass decodes, so that its index arrays stay near 2**25 elements.
CHUNK_ELEMENTS = 1 << 25


def _tag_fields(comp: torch.Tensor):
    """For each position of each row of ``comp`` (u8[B, C]), the fields of a
    tag starting there: (advance to the next tag, length, offset, kind,
    header bytes)."""
    b, c = comp.shape
    x = torch.nn.functional.pad(comp, (0, 5)).long()
    t = x[:, :c]
    e = [x[:, i : c + i] for i in range(1, 5)]
    kind = t & 3
    hi = t >> 2
    nb = (hi - 59).clamp(min=0)  # extra length bytes of a long literal
    ext = e[0] + (e[1] << 8) * (nb >= 2) + (e[2] << 16) * (nb >= 3) + (e[3] << 24) * (nb >= 4)
    litlen = torch.where(hi < 60, hi + 1, ext + 1)
    hdr = torch.where(kind == 0, 1 + nb, torch.zeros_like(nb))
    length = torch.where(kind == 0, litlen, torch.where(kind == 1, 4 + (hi & 7), hi + 1))
    offset = torch.where(
        kind == 1, ((t >> 5) << 8) | e[0],
        torch.where(kind == 2, e[0] | (e[1] << 8), e[0] | (e[1] << 8) | (e[2] << 16) | (e[3] << 24)),
    )
    adv = torch.where(kind == 0, 1 + nb + litlen, torch.where(kind == 1, 2, torch.where(kind == 2, 3, 5)))
    return adv, length, offset, kind, hdr


def _tag_starts(adv: torch.Tensor, clens: torch.Tensor) -> torch.Tensor:
    """i64[B, 2**k]: the i-th tag's position in each row, then the row's
    width C (past every tag) once its tags are done."""
    b, c = adv.shape
    pos = torch.arange(c, device=adv.device)
    nxt = pos + adv
    inside = (nxt < clens[:, None]) & (pos < clens[:, None])
    jump = torch.cat([torch.where(inside, nxt, c), torch.full((b, 1), c, device=adv.device)], dim=1)
    starts = torch.where(clens[:, None] > 0, 0, c).to(torch.long)
    while not bool((starts[:, -1] == c).all()):
        starts = torch.cat([starts, jump.gather(1, starts)], dim=1)
        jump = jump.gather(1, jump)
    return starts


def _decode_chunk(comp, clens, ulens, out_size: int, overlap: bool):
    b, c = comp.shape
    dev = comp.device
    adv, length, offset, kind, hdr = _tag_fields(comp)
    starts = _tag_starts(adv, clens)
    real = starts < c
    row, col = real.nonzero(as_tuple=True)  # row-major: each row's tags in order
    p = starts[row, col]
    t_adv, t_len, t_off, t_kind, t_hdr = (a[row, p] for a in (adv, length, offset, kind, hdr))
    del adv, length, offset, kind, hdr
    zeros = torch.zeros(b, dtype=torch.long, device=dev)
    total = zeros.index_add(0, row, t_len)
    end = torch.cumsum(t_len, 0)
    row_base = torch.cumsum(total, 0) - total
    dst = end - t_len - row_base[row]
    bad_tag = (p + t_adv > clens[row]) | ((t_kind != 0) & ((t_off < 1) | (t_off > dst)))
    bad = zeros.index_add(0, row, bad_tag.long()) > 0
    ok = ~bad & (total == ulens) & (ulens <= out_size)

    keep = ok[row]
    row, p, t_len, t_off, t_kind, t_hdr, dst = (a[keep] for a in (row, p, t_len, t_off, t_kind, t_hdr, dst))
    n = int(t_len.sum())
    tag = torch.repeat_interleave(torch.arange(len(t_len), device=dev), t_len, output_size=n)
    first = torch.cumsum(t_len, 0) - t_len
    k = torch.arange(n, device=dev) - first[tag]
    where = row[tag] * out_size + dst[tag] + k  # each byte's place in the output
    lit = t_kind[tag] == 0
    src_lit = row[tag] * c + p[tag] + t_hdr[tag] + k
    src_ref = where - t_off[tag]
    own = ~lit & (k >= t_off[tag])  # reads bytes its own copy writes
    del tag, k, first

    val = torch.zeros(b * out_size, dtype=torch.uint8, device=dev)
    done = torch.ones(b * out_size, dtype=torch.bool, device=dev)
    ptr = torch.zeros(b * out_size, dtype=torch.long, device=dev)
    flat = comp.reshape(-1)
    val[where[lit]] = flat[src_lit[lit]]
    refs = ~lit if overlap else ~lit & ~own
    done[where[refs]] = False
    ptr[where[refs]] = src_ref[refs]
    pending = where[refs]
    del where, lit, src_lit, src_ref, own, refs
    while pending.numel():
        q = ptr[pending]
        ready = done[q]
        settle = pending[ready]
        val[settle] = val[q[ready]]
        done[settle] = True
        pending = pending[~ready]
        ptr[pending] = ptr[q[~ready]]
    return val.view(b, out_size), ok


def decode_rows(comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int,
                overlap: bool = True):
    """Decode headerless block streams ``comp`` (u8[B, C], ``clens[i]``
    bytes of row i) into (out u8[B, out_size], ok bool[B]); a row is ok where
    its stream is valid and decodes to ``ulens[i]`` bytes. Rows go in chunks
    so that any batch fits."""
    b, c = comp.shape
    clens = clens.to(comp.device, torch.long)
    ulens = ulens.to(comp.device, torch.long)
    if bool(((clens < 0) | (clens > c)).any()):
        raise ValueError("clens must lie in [0, C]")
    step = max(1, CHUNK_ELEMENTS // max(c, out_size, 1))
    outs, oks = [], []
    for lo in range(0, b, step):
        o, k = _decode_chunk(comp[lo : lo + step], clens[lo : lo + step], ulens[lo : lo + step], out_size, overlap)
        outs.append(o)
        oks.append(k)
    if not outs:
        return torch.zeros((0, out_size), dtype=torch.uint8, device=comp.device), torch.zeros(0, dtype=torch.bool)
    return torch.cat(outs), torch.cat(oks)


def decode_raw(stream: bytes, overlap: bool = True) -> bytes | None:
    """A whole raw Snappy stream (varint length, then tags) decoded, or None
    where it is invalid."""
    n, shift, i = 0, 0, 0
    while True:
        if i >= len(stream) or i == 5:
            return None
        byte = stream[i]
        n |= (byte & 0x7F) << shift
        shift += 7
        i += 1
        if byte < 0x80:
            break
    if n >= 1 << 32:
        return None
    body = torch.from_numpy(np.frombuffer(stream, np.uint8)[i:].copy())[None, :]
    out, ok = decode_rows(body, torch.tensor([body.shape[1]]), torch.tensor([n]), max(n, 1), overlap)
    return out[0, :n].numpy().tobytes() if bool(ok[0]) else None
