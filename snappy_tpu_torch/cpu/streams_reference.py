"""The plain reference of ``parallel/distributed.py::decompress_streams``.

Plain torch, on any device, that imports no kernel and nothing else of the
port: each raw Snappy stream is decoded alone, with no segments and no
batching, into its place in the output, by google/snappy's format
description (``format_description.txt``):

- the stream starts with its length as a varint of at most 5 bytes (the
  fifth below 0x10), which must equal the length the caller states;
- then tags: a literal (kind 0) holds its length less one in its upper six
  bits, or, where those read 60 to 63, in the 1 to 4 bytes after the tag,
  and then its bytes; a copy (kinds 1, 2, 3: an offset of 11, 16 or 32
  bits) repeats ``length`` bytes from ``offset`` bytes back in the output,
  byte by byte, so a copy may read what it writes;
- a stream is corrupt where a tag or its bytes run past the stream's end, a
  copy's offset is 0 or reaches before the output's start, or the output's
  length differs from the header's. The walk stops when fewer than 2 bytes
  remain, so one byte after the last tag is ignored, as libsnappy does.

A stream decodes in three steps, none a loop over its tags: every byte
position is read as if a tag started there, giving the next tag's position;
the tags are the positions reached from the first by that map, found by
pointer doubling; each output byte is a literal byte or a reference to an
earlier output byte, and references are followed by pointer jumping.
"""

from __future__ import annotations

import torch

_MAX_HEADER = 5


def _header(stream: torch.Tensor) -> tuple[int, int] | None:
    """(length, header bytes) of the varint at the start of ``stream``, or
    None where there is none."""
    head = stream[:_MAX_HEADER].tolist()
    value = 0
    for k, b in enumerate(head):
        if k == _MAX_HEADER - 1 and b >= 0x10:
            return None
        value |= (b & 0x7F) << (7 * k)
        if b < 0x80:
            return value, k + 1
    return None


def decode_body(body: torch.Tensor, ulen: int) -> torch.Tensor | None:
    """The ``ulen`` bytes a headerless tag stream (uint8[n]) decodes to, on
    its device, or None where it is corrupt."""
    dev = body.device
    n = body.shape[0]
    if ulen == 0 or n < 2:
        return torch.zeros(0, dtype=torch.uint8, device=dev) if ulen == 0 and n < 2 else None
    x = torch.nn.functional.pad(body, (0, 4)).long()
    c = x[:n]
    after = [x[i : n + i] for i in range(1, 5)]
    kind, hi = c & 3, c >> 2
    extra = torch.where(kind == 0, (hi - 59).clamp(min=0), torch.where(kind == 3, 4, kind))
    word = after[0] | after[1] << 8 | after[2] << 16 | after[3] << 24
    field = word & ((1 << (8 * extra)) - 1)
    length = torch.where(kind == 0, torch.where(hi < 60, hi + 1, field + 1),
                         torch.where(kind == 1, 4 + (hi & 7), hi + 1))
    offset = torch.where(kind == 1, (hi >> 3) << 8 | (word & 0xFF), field)
    head = 1 + extra
    advance = head + torch.where(kind == 0, length, 0)

    # The tags: positions reached from 0, walking while 2 bytes remain.
    pos = torch.arange(n, device=dev)
    nxt = pos + advance
    step = torch.cat([torch.where((pos + 1 < n) & (nxt < n), nxt, n), torch.tensor([n], device=dev)])
    chain = torch.zeros(1, dtype=torch.long, device=dev)
    while True:
        grown = torch.cat([chain, step[chain]]).unique()
        if grown.shape[0] == chain.shape[0]:
            break
        chain, step = grown, step[step]
    tags = chain[(chain < n) & (chain + 1 < n)]
    t_len, t_off, t_kind, t_head = length[tags], offset[tags], kind[tags], head[tags]
    dst = torch.cumsum(t_len, 0) - t_len
    if int(t_len.sum()) != ulen:
        return None
    bad = (tags + advance[tags] > n) | ((t_kind != 0) & ((t_off == 0) | (t_off > dst)))
    if bool(bad.any()):
        return None

    # Each output byte: a literal byte of the body, or the byte offset back.
    tag = torch.repeat_interleave(torch.arange(len(tags), device=dev), t_len, output_size=ulen)
    k = torch.arange(ulen, device=dev) - dst[tag]
    lit = t_kind[tag] == 0
    src = torch.where(lit, torch.arange(ulen, device=dev), torch.arange(ulen, device=dev) - t_off[tag])
    value = torch.where(lit, body[(tags[tag] + t_head[tag] + k).clamp(max=n - 1)], 0).to(torch.uint8)
    done = lit.clone()
    while not bool(done.all()):
        value = torch.where(done, value, value[src])
        done = done | done[src]
        src = src[src]
    return value


def decompress_streams(comp: torch.Tensor, starts, clens, ulens, out_starts, out_len: int):
    """(out uint8[out_len], ok bool[n]): each stream decoded alone into its
    place, on ``comp``'s device; the output is zero wherever no ok stream
    writes. The arguments are ``decompress_streams``'s."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = comp.device
    out = torch.zeros(out_len, dtype=torch.uint8, device=dev)
    ok = torch.zeros(len(starts), dtype=torch.bool, device=dev)
    for i, (start, clen, ulen, out0) in enumerate(zip(*(torch.as_tensor(t).tolist() for t in
                                                           (starts, clens, ulens, out_starts)))):
        if not (0 <= start <= comp.numel() - clen and clen >= 0 and 0 <= ulen and 0 <= out0 <= out_len - ulen):
            continue
        stream = comp[start : start + clen]
        header = _header(stream)
        if header is None or header[0] != ulen:
            continue
        value = decode_body(stream[header[1] :], ulen)
        if value is not None:
            out[out0 : out0 + ulen] = value
            ok[i] = True
    return out, ok
