"""Plain PyTorch block decoder: the plain version of the CUDA kernel.

The counterpart of ``snappy_tpu/ops/decode_xla.py`` (``:56-220``), written
in torch ops on any device. It decodes B independent tag streams without a
serial loop, in two passes:

  pass 1  a candidate tag is parsed at EVERY byte position, giving a
          strictly increasing successor map; the true tag boundaries are
          the orbit of the stream start under it, found by pointer doubling
          and then sorted.
  pass 2  output offsets per tag by a prefix sum; each output byte finds
          its tag by a batched ``searchsorted``; copy sources are chased
          to their literal fixpoint in O(log n) gather rounds, which
          resolves overlapping (RLE) copies.

``ops/cuda_decode.py`` runs this on CPU tensors and compares its kernel
against it on the card. The two agree bit for bit on ``out`` and ``ok``,
and on ``total`` where ``ok``:

- ``out`` holds the decoded bytes where ``ok`` and zero past ``total``;
  a row that is not ``ok`` is all zero;
- the walk stops when fewer than 2 bytes remain, so one trailing byte
  after the last tag is ignored (as ``decode_xla`` and the native decoder
  do);
- a copy tag whose offset bytes run past ``clen`` is corrupt. Here this
  departs from ``decode_xla``, which reads the zero padding as offset
  bytes and accepts such a stream;
- ``total`` of a row that is not ``ok`` is not specified.

``torch.gather`` raises on out-of-range indices where ``jnp.take_along_axis``
clamps, so every index is clamped explicitly, as ``decode_xla`` relies on.
"""

from __future__ import annotations

import torch

from .primitives import (
    CHAR_TABLE_I64,
    WORDMASK_I64,
    ceil_log2,
    exclusive_cumsum,
    le32_at_every_position,
)

# Slack bytes each row carries past its stream, so that the 4-byte trailer
# load at the last positions stays inside the row.
COMP_PAD = 4

# Largest headerless stream the plain version decodes as one block: its
# intermediates grow with the stream. ``ops/host.py`` refuses larger
# unsegmentable raw streams on the CPU.
RAW_WHOLE_LIMIT = 4 << 20

_I64 = torch.int64
_I32_MAX = (1 << 31) - 1


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def parse_all_positions(comp_padded: torch.Tensor, limit: int) -> dict[str, torch.Tensor]:
    """Decode a candidate tag at every byte position (batched).

    comp_padded: uint8[B, Nc + COMP_PAD]. Returns int64/bool [B, Nc] fields.
    ``limit`` clamps the trailer above any valid length, as decode_xla does.
    """
    nc = comp_padded.shape[-1] - COMP_PAD
    dev = comp_padded.device
    c = comp_padded[..., :nc].to(_I64)
    entry = CHAR_TABLE_I64.to(dev)[c]
    taglen = entry >> 11
    tag32 = le32_at_every_position(comp_padded)
    trailer = tag32[..., 1 : nc + 1] & WORDMASK_I64.to(dev)[taglen]
    trailer = torch.clamp(trailer, max=limit)
    is_copy = (c & 3) != 0
    length = entry & 0xFF
    lit_len = length + trailer
    return {
        "is_copy": is_copy,
        "taglen": taglen,
        "out_len": torch.where(is_copy, length, lit_len),
        "consumed": 1 + taglen + torch.where(is_copy, 0, lit_len),
        "offset": (entry & 0x700) + trailer,
        "lit_len": lit_len,
    }


def tag_orbit(starts: torch.Tensor, nxt: torch.Tensor, max_tags: int) -> torch.Tensor:
    """Sorted tag positions: the orbit of starts[b] under i -> nxt[b, i].

    nxt: int64[B, N], strictly increasing per row, values in [0, N] with N
    the absorbing sentinel. Returns int64[B, CAP] ascending, CAP = max_tags
    rounded up to a power of two; slots past the orbit hold N.
    """
    b, n = nxt.shape
    jump = torch.cat([nxt, torch.full((b, 1), n, dtype=_I64, device=nxt.device)], dim=-1)
    orbit = starts.to(_I64)[:, None]
    for _ in range(ceil_log2(max_tags)):
        orbit = torch.cat([orbit, _take(jump, orbit)], dim=-1)
        jump = _take(jump, jump)
    return torch.sort(torch.clamp(orbit, max=n), dim=-1).values


def decode_blocks_impl(comp, clens, ulens, starts, out_size: int):
    """Decode B independent tag streams.

    comp: uint8[B, Nc + COMP_PAD], zero past each clen.
    clens, ulens, starts: [B] integer tensors: compressed lengths, claimed
        output lengths (<= out_size), first tag positions.
    Returns (out uint8[B, out_size], ok bool[B], total int32[B]).
    """
    b = comp.shape[0]
    nc = comp.shape[-1] - COMP_PAD
    nu = out_size
    dev = comp.device
    pos = torch.arange(nc, dtype=_I64, device=dev)[None, :]
    clens_c = clens.to(_I64)[:, None]
    ulens_c = ulens.to(_I64)[:, None]
    starts = starts.to(_I64)

    t = parse_all_positions(comp, nc + nu + 16)

    # pass 1: tag boundaries = sorted orbit of the successor map.
    nxt = torch.clamp(pos + t["consumed"], max=nc)
    # Every tag consumes >= 2 bytes, so a chain holds at most nc/2+2 tags.
    tags = tag_orbit(starts, nxt, nc // 2 + 2)
    # A tag never starts at the final byte: it needs >= 2 bytes.
    valid = (tags < clens_c - 1) & (tags >= starts[:, None])
    tags_c = torch.clamp(tags, max=nc - 1)

    def tag_field(arr):
        return torch.where(valid, _take(arr, tags_c), 0)

    t_out_len = tag_field(t["out_len"])
    t_is_copy = valid & _take(t["is_copy"], tags_c)
    t_offset = tag_field(t["offset"])
    t_taglen = tag_field(t["taglen"])
    t_lit_len = tag_field(t["lit_len"])
    del t, nxt

    # pass 2: output offsets per tag, and the corruption checks.
    topos = exclusive_cumsum(t_out_len)
    total = t_out_len.sum(-1)
    tag_end = tags + 1 + t_taglen
    bad_copy = (
        (t_offset == 0)
        | (topos < t_offset)
        | (topos + t_out_len > ulens_c)
        | (tag_end > clens_c)
    )
    bad_lit = (tag_end + t_lit_len > clens_c) | (topos + t_lit_len > ulens_c)
    bad = valid & torch.where(t_is_copy, bad_copy, bad_lit)
    ok = ~bad.any(-1) & (total == ulens_c[:, 0])

    # Materialize: each output byte finds its tag by binary search over the
    # tag output offsets.
    topos_key = torch.where(valid, topos, nu + nc + 32)
    out_iota = torch.arange(nu, dtype=_I64, device=dev)[None, :]
    tagidx = torch.searchsorted(topos_key, out_iota.expand(b, nu).contiguous(), right=True)
    tagidx = torch.clamp(tagidx - 1, 0, tags.shape[-1] - 1)

    o_iscopy = _take(t_is_copy, tagidx)
    delta = out_iota - _take(topos, tagidx)
    lit_idx = torch.clamp(_take(tag_end, tagidx) + delta, 0, nc + COMP_PAD - 1)
    lit_val = _take(comp, lit_idx)
    src = torch.where(o_iscopy, out_iota - _take(t_offset, tagidx), out_iota)
    src = torch.clamp(src, 0, nu - 1)
    del tagidx, o_iscopy, delta, lit_idx

    # Resolve back-reference chains to their literal fixpoints.
    for _ in range(ceil_log2(nu + 1)):
        src = _take(src, src)
    out = _take(lit_val, src)
    keep = ok[:, None] & (out_iota < total[:, None])
    out = torch.where(keep, out, 0)
    return out, ok, torch.clamp(total, max=_I32_MAX).to(torch.int32)


def decode_blocks(comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int):
    """Decode a batch of independent headerless block tag streams."""
    return decode_blocks_impl(comp, clens, ulens, torch.zeros_like(clens), out_size)
