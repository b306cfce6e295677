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

``decode_blocks_r4`` is the plain version of ``csrc/decode_blocks_r4.cu``,
the port of the pinned round-4 decoder ``snappy_tpu/ops/pallas_decode_r4.py``
(K3). It is the same function with K3's narrower envelope, set through the
parameters of ``decode_blocks_impl``: a copy offset above 0xFFFF and a
literal over 65,536 bytes are corrupt, and a byte left after the last tag is
read as a tag, so the block is rejected. Its other rules are the ones above.

``decode_raw_windowed`` is the counterpart of ``decode_xla``'s windowed
decoder (``:244-404``): a raw stream too large for one block on the CPU,
decoded in fixed windows with the output carried between them.

``torch.gather`` raises on out-of-range indices where ``jnp.take_along_axis``
clamps, so every index is clamped explicitly, as ``decode_xla`` relies on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import CorruptInputError
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
# intermediates grow with the stream. ``ops/host.py`` sends larger
# unsegmentable raw streams on the CPU to ``decode_raw_windowed``.
RAW_WHOLE_LIMIT = 4 << 20
WINDOW_C = 1 << 20  # compressed bytes scanned per window
WINDOW_U = (1 << 20) + (1 << 17)  # output bytes materialized per window

# K3's envelope (pallas_decode_r4.py:179, :192-198).
R4_MAX_OFFSET = 0xFFFF
R4_MAX_LITERAL = 0x10000

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


def decode_blocks_impl(
    comp,
    clens,
    ulens,
    starts,
    out_size: int,
    *,
    max_offset: int | None = None,
    max_literal: int | None = None,
    trailing_byte_is_tag: bool = False,
):
    """Decode B independent tag streams.

    comp: uint8[B, Nc + COMP_PAD], zero past each clen.
    clens, ulens, starts: [B] integer tensors: compressed lengths, claimed
        output lengths (<= out_size), first tag positions.
    max_offset, max_literal: the largest copy offset and literal length a
        block may hold (None: no cap beyond the output so far and the input).
    trailing_byte_is_tag: read a byte left after the last tag as a tag (which
        cannot complete, so the block is corrupt) instead of ignoring it.
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
    # Every tag needs >= 2 bytes, so one at the final byte is corrupt; by
    # default the walk stops before it instead.
    last = clens_c if trailing_byte_is_tag else clens_c - 1
    valid = (tags < last) & (tags >= starts[:, None])
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
    if max_offset is not None:
        bad_copy |= t_offset > max_offset
    if max_literal is not None:
        bad_lit |= t_lit_len > max_literal
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


def decode_blocks_r4(comp: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor, out_size: int):
    """``decode_blocks`` within K3's envelope (see the module docstring)."""
    return decode_blocks_impl(
        comp,
        clens,
        ulens,
        torch.zeros_like(clens),
        out_size,
        max_offset=R4_MAX_OFFSET,
        max_literal=R4_MAX_LITERAL,
        trailing_byte_is_tag=True,
    )


def _window_pass(comp_w: torch.Tensor, wc: int, obase: int, window_u: int):
    """Decode one window of a raw tag stream (one row, bounded shapes).

    comp_w: uint8[WINDOW_C + COMP_PAD], the stream's bytes from the current
    tag position; wc: valid bytes of that slice; obase: absolute output
    position of the window's first tag. Decodes every tag that both ends
    within the window and keeps the window's output <= window_u.

    Returns (vals, srcs, hist, produced, consumed, ok):
      vals  uint8[window_u]: literal bytes of the window's output positions
      srcs  int64[window_u]: absolute source positions after chasing the
            in-window copy chains; those < obase point into output already
            materialized, the others are literal fixpoints in the window
      hist  bool[window_u]: srcs points into that history
      produced, consumed: output and input bytes the window covers
      ok: False if the decoded prefix is corrupt
    """
    nc = comp_w.shape[-1] - COMP_PAD
    comp2 = comp_w[None, :]
    pos = torch.arange(nc, dtype=_I64)[None, :]
    t = parse_all_positions(comp2, nc + window_u + 16)

    nxt = torch.clamp(pos + t["consumed"], max=nc)
    tags = tag_orbit(torch.zeros(1, dtype=_I64), nxt, nc // 2 + 2)
    tags_c = torch.clamp(tags, max=nc - 1)
    inside = tags < nc

    def tf(arr):
        return torch.where(inside, _take(arr, tags_c), 0)

    t_out = tf(t["out_len"])
    t_cons = tf(t["consumed"])
    t_copy = inside & _take(t["is_copy"], tags_c)
    t_off = tf(t["offset"])
    t_taglen = tf(t["taglen"])
    t_lit = tf(t["lit_len"])
    del t, nxt

    # Keep the tags inside [0, wc) whose output fits window_u: a prefix of
    # the chain.
    topos = exclusive_cumsum(t_out)
    keep = (tags + t_cons <= wc) & (tags < wc - 1) & (topos + t_out <= window_u)
    keep = torch.cumprod(keep.to(_I64), dim=-1) > 0
    produced = int(torch.where(keep, t_out, 0).sum())
    consumed = int(torch.where(keep, tags + t_cons, 0).max())

    # Corruption checks on the kept prefix, in absolute output positions.
    bad_copy = (t_off == 0) | (topos + obase < t_off)
    bad_lit = tags + 1 + t_taglen + t_lit > wc
    ok = not bool((keep & torch.where(t_copy, bad_copy, bad_lit)).any())

    key = torch.where(keep, topos, window_u + nc + 32)
    oi = torch.arange(window_u, dtype=_I64)[None, :]
    tagidx = torch.clamp(torch.searchsorted(key, oi, right=True) - 1, 0, tags.shape[-1] - 1)
    o_copy = _take(t_copy, tagidx)
    lit_idx = torch.clamp(_take(tags_c + 1 + t_taglen, tagidx) + oi - _take(topos, tagidx), 0, nc + COMP_PAD - 1)
    vals = _take(comp2, lit_idx)
    src = torch.where(o_copy, oi + obase - _take(t_off, tagidx), oi + obase)
    del tagidx, o_copy, lit_idx

    # Chase in-window chains; a source in the history is a fixpoint.
    for _ in range(ceil_log2(window_u + 1)):
        rel = src - obase
        src = torch.where(rel < 0, src, _take(src, torch.clamp(rel, 0, window_u - 1)))
    return vals[0], src[0], src[0] < obase, produced, consumed, ok


def decode_raw_windowed(comp, ulen: int, start: int) -> bytes:
    """Decode one raw stream on the CPU in bounded memory, window by window.

    ``comp`` is the whole stream as a uint8 array, ``ulen`` its
    header's length and ``start`` the first tag's position. Each window of
    WINDOW_C compressed bytes is decoded by ``_window_pass``; copies that
    reach back before the window read the output carried so far. A literal
    longer than a window is copied on the host. Memory: O(WINDOW_C +
    WINDOW_U + ulen). Raises CorruptInputError on a corrupt stream.
    """
    comp = np.asarray(comp, np.uint8)
    out = np.empty(ulen, np.uint8)
    window_c, window_u = WINDOW_C, WINDOW_U
    p, o = start, 0
    clen = len(comp)
    while p < clen and o < ulen:
        wc = min(window_c, clen - p)
        win = np.zeros(window_c + COMP_PAD, np.uint8)
        win[:wc] = comp[p : p + wc]
        vals, srcs, hist, produced, consumed, ok = _window_pass(torch.from_numpy(win), wc, o, window_u)
        if not ok:
            raise CorruptInputError("corrupt snappy stream")
        if consumed == 0 or produced == 0:
            # No tag fit the window: a literal longer than it (copied here)
            # or corruption.
            c = int(comp[p])
            if (c & 3) != 0:
                raise CorruptInputError("corrupt snappy stream")
            extra = max((c >> 2) - 59, 0)
            if extra == 0 or p + 1 + extra > clen:
                raise CorruptInputError("corrupt snappy stream")
            lit = int.from_bytes(comp[p + 1 : p + 1 + extra].tobytes(), "little") + 1
            body = p + 1 + extra
            if body + lit > clen or o + lit > ulen:
                raise CorruptInputError("corrupt snappy stream")
            out[o : o + lit] = comp[body : body + lit]
            p = body + lit
            o += lit
            continue
        if o + produced > ulen:
            raise CorruptInputError("corrupt snappy stream")
        vals = vals.numpy()
        srcs = srcs[:produced].numpy()
        hist = hist[:produced].numpy()
        # History entries index the output so far; in-window entries take
        # the literal byte at their chased fixpoint.
        hidx = np.clip(srcs, 0, max(o - 1, 0))
        widx = np.clip(srcs - o, 0, window_u - 1)
        out[o : o + produced] = np.where(hist, out[hidx], vals[widx])
        p += consumed
        o += produced
    if o != ulen or p != clen:
        raise CorruptInputError("corrupt snappy stream")
    return out.tobytes()
