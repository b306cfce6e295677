"""Array-program block encoder: the counterpart of ``snappy_tpu/ops/encode_xla.py``.

The JAX package writes this parse wherever there is no TPU
(``snappy_tpu/ops/select.py::block_encoder``, ``encode_xla._best_encoder``);
here it is plain torch on whatever device its tensors are on, reached as
``encoder="array"`` (``ops/select.py``). ``encode_blocks(blocks, blens,
min_profit)`` turns B blocks, uint8[B, W], into their headerless tag
streams (out uint8[B, BLOCK_MAX_OUT], olens int32[B]), byte for byte the
reference's ``encode_blocks_jit``. The block size is W - ENC_PAD, read from
the row width. ``min_profit`` is taken for the contract of
``select.block_encoder`` and not read: like the reference, this encoder
parses at its own thresholds 0 and 2 and keeps the smaller stream.

For each row, with ``key(p)`` the little-endian 4-byte value at p:

1. Candidates (``_find_candidates``): a stable sort of the keys gives each
   position the two most recent earlier positions with the same key.
2. Extension (``_match_lengths``): each candidate's match length, capped
   at ``MATCH_CAP`` and cut at the block's end: links to the lane 4 bytes
   on at the same offset, followed by pointer doubling, then the
   reference's 4-byte rounds for the lanes that end a chain, compacted
   every round.
3. Choice: the older candidate where it saves strictly more bytes, then
   lazy demotion (a match gives way to a strictly more profitable one at
   the next position).
4. Two parses (``_parse``) at profit thresholds 0 and 2: the orbit of 0
   under p -> p + match length (or p + 1), by pointer doubling
   (``primitives.reach_from``); literal runs run to the next copy. The row
   keeps the smaller.
5. Emission (``_emit``): tag offsets by prefix sum; every output byte finds
   its tag by a running maximum and computes itself from the tag's record.

Rows are independent: a batch is encoded in chunks of rows whose working
memory stays under ``CHUNK_BYTES``, and no byte depends on the chunking.
``out`` is zero past ``olens``.
"""

from __future__ import annotations

import torch

from ..core.config import DEFAULT_CONFIG
from .encode_torch import BLOCK_MAX_OUT, ENC_PAD, _equal_leading_bytes
from .primitives import ceil_log2, exclusive_cumsum, le32_at_every_position, reach_from

# Longest match the extension measures; a longer one re-matches at the next
# parse position at the same offset (encode_xla.py:56).
MATCH_CAP = DEFAULT_CONFIG.max_match_scan
# The off-TPU encoder's two parse thresholds (encode_xla.py:143-149).
MIN_PROFIT = 0
MIN_PROFIT_INCOMPRESSIBLE = 2
# Working memory of one chunk of rows by device type, and what a row takes
# of it for each byte of its width (measured peaks of 64 KiB corpus rows:
# ~290 on the CPU, ~230 on an H100).
CHUNK_BYTES = {"cpu": 1 << 30, "cuda": 8 << 30}
ROW_BYTES_PER_BYTE = 320

_I32 = torch.int32
_I64 = torch.int64
# Fields of a tag's record in _emit: its output offset, input position and kind.
_POS_BITS = 17
_KEY_SHIFT = _POS_BITS + 1


def _find_candidates(u32: torch.Tensor, blen: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two most recent earlier positions of each position's key:
    (cand1, cand2) int64[R, n], -1 where there is none or where its 4-byte
    group runs past the block (encode_xla.py:69-93). The sort is stable, so
    equal keys keep position order and the ranks just below a position's
    are its most recent earlier occurrences."""
    sv, order = torch.sort(u32, dim=-1, stable=True)

    def prev_k(k: int) -> torch.Tensor:
        prev = torch.full_like(order, -1)
        prev[:, k:] = torch.where(sv[:, k:] == sv[:, :-k], order[:, :-k], -1)
        cand = torch.empty_like(order).scatter_(-1, order, prev)
        return torch.where((cand >= 0) & (cand <= blen - 4), cand, -1)

    return prev_k(1), prev_k(2)


def _match_lengths(u32: torch.Tensor, cands: torch.Tensor, blen: torch.Tensor, cap: int) -> torch.Tensor:
    """Match length of each candidate, int32[K, R, n] for cands int64[K, R, n]:
    >= 4 where the candidate's key equals the position's, capped at ``cap``
    and cut at blen; 0 elsewhere (encode_xla.py:96-122).

    The reference's loop extends every lane 4 bytes a round while all 4
    agree, so a lane's length is min(common prefix, blen - p, cap). Two
    exact shortcuts give the same lengths:
    - Chains. Where the lane 4 bytes on holds the same offset (its
      candidate is c + 4), this lane's prefix is 4 longer than that one's:
      the keys at p and c agree (``_chain_links``). Pointer doubling follows
      those links for ceil(log2(cap / 4)) rounds, past which a chain
      reaches the cap (``_follow_chains``).
    - Compaction. The lanes that end a chain extend in the reference's
      loop, carrying only the live ones to the next round
      (``_extend_ends``).
    """
    k, r, n = cands.shape
    pos = torch.arange(n, device=u32.device)
    valid = (cands >= 0) & (u32.expand(k, r, n).gather(-1, cands.clamp(min=0)) == u32) & (pos <= blen - 4)
    lim = (blen - pos).clamp(max=cap)
    jump, end = _chain_links(valid, cands)
    steps, jump = _follow_chains(jump, end, ceil_log2(cap // 4))
    ml_end = _extend_ends(u32, cands, valid & end.view(k, r, n), lim, cap)
    # A lane whose chain reached the cap before its end takes cap from there.
    ml = torch.minimum((4 * steps + ml_end[jump]).view(k, r, n), lim)
    return torch.where(valid, ml, 0).to(_I32)


def _chain_links(valid: torch.Tensor, cands: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's successor, int64[K * R * n] in flat lane order: the valid
    lane at p + 4 whose candidate is c + 4, or the lane itself where there
    is none; and bool[K * R * n], whether the lane ends its chain."""
    k, r, n = cands.shape
    lanes = torch.arange(k * r * n, device=cands.device).view(k, r, n)
    jump = lanes.clone()
    for k2 in range(k):
        hit = valid[:, :, :-4] & valid[k2, :, 4:] & (cands[k2, :, 4:] == cands[:, :, :-4] + 4)
        jump[:, :, :-4] = torch.where(hit, lanes[k2, :, 4:], jump[:, :, :-4])
    jump = jump.view(-1)
    return jump, jump == lanes.view(-1)


def _follow_chains(jump: torch.Tensor, end: torch.Tensor, rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(links followed, the lane reached) from each lane after ``rounds``
    rounds of pointer doubling: at most 2**rounds links, and the chain's
    end where it is nearer."""
    steps = (~end).to(_I64)
    for _ in range(rounds):
        steps = steps + steps[jump]
        jump = jump[jump]
    return steps, jump


def _extend_ends(u32: torch.Tensor, cands: torch.Tensor, ends: torch.Tensor, lim: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Match length of each lane of ``ends`` (bool[K, R, n]), int64[K * R * n]
    in flat lane order, ``cap`` at the other lanes; ``lim`` [R, n] is
    min(blen - p, cap). The reference's rounds: 4 bytes a round while all 4
    agree, the live lanes compacted every round, so a round costs what is
    still extending and the loop stops when none is (reading how many are
    live is the round's one wait for the device)."""
    k, r, n = cands.shape
    flat = u32.reshape(-1)
    ml = torch.full((k * r * n,), cap, dtype=_I64, device=u32.device)
    lane = ends.view(-1).nonzero().squeeze(1)
    p = lane % n
    base = lane // n % r * n
    c = cands.view(-1)[lane]
    room = lim.view(-1)[lane % (r * n)]
    cur = torch.full_like(lane, 4)
    ml.index_fill_(0, lane, 4)
    for _ in range(cap // 4):
        if lane.numel() == 0:
            break
        a = flat[base + (p + cur).clamp(max=n - 1)]
        b = flat[base + (c + cur).clamp(max=n - 1)]
        raw = torch.where(a == b, 4, _equal_leading_bytes(a ^ b))
        add = torch.minimum(raw, room - cur).clamp(min=0)
        cur += add
        ml.scatter_(0, lane, cur)
        live = (add == 4).nonzero().squeeze(1)
        lane, p, base, c, room, cur = (t[live] for t in (lane, p, base, c, room, cur))
    return ml


def _copy_nbytes(m: torch.Tensor, d: torch.Tensor):
    """Bytes a copy of length m at offset d emits, and its chunks: (nbytes,
    k64 full 64-byte chunks, has60, rem, rem2 = the remainder takes a
    COPY_1), as encode_xla.py:125-136."""
    k64 = torch.where(m >= 68, (m - 4) // 64, 0)
    m2 = m - 64 * k64
    has60 = (m2 > 64).to(m.dtype)
    rem = m2 - 60 * has60
    rem2 = (rem < 12) & (d < 2048)
    nbytes = 3 * (k64 + has60) + 3 - rem2.to(m.dtype)
    return nbytes, k64, has60, rem, rem2


def _literal_header_len(length: torch.Tensor) -> torch.Tensor:
    nm1 = length - 1
    return 1 + (nm1 >= 60).to(length.dtype) + (nm1 >= 256).to(length.dtype)


def _parse(takeable: torch.Tensor, profit: torch.Tensor, ml: torch.Tensor, cbytes: torch.Tensor,
           blen: torch.Tensor, min_p: int):
    """The greedy parse at profit threshold ``min_p`` (encode_xla.py:173-206):
    (olen int64[R], is_copy_tag, is_lit_start, lit_len, size), the last
    four [R, n]. Positions reached from 0 with a match are copy tags, and a
    reached literal after an unreached position starts a literal run that
    lasts to the next copy tag or the block's end."""
    r, n = ml.shape
    pos = torch.arange(n, dtype=_I32, device=ml.device)
    is_match = takeable & (profit >= min_p)
    nxt = torch.where(is_match, pos + ml, pos + 1).clamp(max=n)
    reached = reach_from(0, nxt, n) & (pos < blen)
    is_copy_tag = reached & is_match
    reached_prev = torch.zeros_like(reached)
    reached_prev[:, 1:] = reached[:, :-1]
    is_lit_start = reached & ~is_match & ~reached_prev
    copy_pos = torch.where(is_copy_tag, pos, n + 1)
    next_copy = torch.cummin(copy_pos.flip(-1), dim=-1).values.flip(-1)
    lit_len = torch.minimum(next_copy, blen) - pos
    size = torch.where(is_copy_tag, cbytes, 0) + torch.where(
        is_lit_start, _literal_header_len(lit_len.clamp(min=1)) + lit_len, 0
    )
    return size.sum(-1), is_copy_tag, is_lit_start, lit_len, size


def _copy_bytes(delta: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Byte ``delta`` of the tags of a copy of length m at offset d
    (encode_xla.py:238-252): COPY_2 chunks of 64, one of 60, then the
    remainder as COPY_1 or COPY_2."""
    _, k64, has60, rem, rem2 = _copy_nbytes(m, d)
    nfull = k64 + has60
    chunk_len = torch.where(delta // 3 < k64, 64, 60)
    at = delta % 3
    full_byte = torch.where(at == 0, 0x02 | ((chunk_len - 1) << 2), torch.where(at == 1, d & 0xFF, d >> 8))
    rd = delta - 3 * nfull
    byte2 = torch.where(rd == 0, 0x01 | ((rem - 4) << 2) | ((d >> 8) << 5), d & 0xFF)
    byte3 = torch.where(rd == 0, 0x02 | ((rem - 1) << 2), torch.where(rd == 1, d & 0xFF, d >> 8))
    return torch.where(delta < 3 * nfull, full_byte, torch.where(rem2, byte2, byte3))


def _literal_bytes(blocks: torch.Tensor, delta: torch.Tensor, p: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Byte ``delta`` of a literal run of ``length`` bytes from input
    position p: its header, then its bytes (encode_xla.py:254-264)."""
    nm1 = length - 1
    hl = _literal_header_len(length.clamp(min=1))
    hdr = torch.where(
        delta == 0,
        torch.where(hl == 1, nm1 << 2, torch.where(hl == 2, 60 << 2, 61 << 2)),
        torch.where(delta == 1, nm1 & 0xFF, nm1 >> 8),
    )
    body = blocks.gather(-1, (p + delta - hl).clamp(0, blocks.shape[1] - 1)).to(_I32)
    return torch.where(delta < hl, hdr, body)


def _emit(blocks: torch.Tensor, olen: torch.Tensor, is_copy_tag: torch.Tensor, is_lit_start: torch.Tensor,
          lit_len: torch.Tensor, size: torch.Tensor, ml: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """The tag streams, uint8[R, BLOCK_MAX_OUT], zero past olen
    (encode_xla.py:218-268). Each tag's record (output offset, input
    position, copy or literal) is scattered at its output offset, one spare
    slot past the end taking the positions that start no tag; a running
    maximum carries each record over its tag's bytes, as offsets and
    positions grow together."""
    r, n = ml.shape
    dev = blocks.device
    mo = BLOCK_MAX_OUT
    pos = torch.arange(n, device=dev)
    out_off = exclusive_cumsum(size.to(_I64))
    key = (out_off << _KEY_SHIFT) | (pos << 1) | is_copy_tag.to(_I64)
    slot = torch.where(is_copy_tag | is_lit_start, out_off, mo)
    rec = torch.zeros((r, mo + 1), dtype=_I64, device=dev).scatter_(-1, slot, key)[:, :mo]
    rec = torch.cummax(rec, dim=-1).values
    iota = torch.arange(mo, device=dev)
    delta = (iota - (rec >> _KEY_SHIFT)).to(_I32)
    p = (rec >> 1) & ((1 << _POS_BITS) - 1)
    is_copy = (rec & 1) > 0
    del rec
    field = torch.where(is_copy_tag, (ml << 16) | offset, lit_len).gather(-1, p)
    out = torch.where(
        is_copy,
        _copy_bytes(delta, field >> 16, field & 0xFFFF),
        _literal_bytes(blocks, delta, p, field),
    )
    return torch.where(iota < olen[:, None], out & 0xFF, 0).to(torch.uint8)


def _encode_rows(blocks: torch.Tensor, blens: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``encode_xla.encode_block`` on each row of one chunk (:143-268)."""
    n = blocks.shape[1] - ENC_PAD
    pos = torch.arange(n, dtype=_I32, device=blocks.device)
    blen = blens.to(_I64)[:, None]
    u32 = le32_at_every_position(blocks)[:, :n]
    cand1, cand2 = _find_candidates(u32, blen)
    ml1, ml2 = _match_lengths(u32, torch.stack((cand1, cand2)), blen, cap)
    del u32
    cand1, cand2 = cand1.to(_I32), cand2.to(_I32)
    cb1 = _copy_nbytes(ml1.clamp(min=4), (pos - cand1).clamp(min=1))[0]
    cb2 = _copy_nbytes(ml2.clamp(min=4), (pos - cand2).clamp(min=1))[0]
    # The older candidate only where strictly more profitable.
    use2 = torch.where(ml2 >= 4, ml2 - cb2, -1) > torch.where(ml1 >= 4, ml1 - cb1, -1)
    ml = torch.where(use2, ml2, ml1)
    offset = torch.where(ml >= 4, pos - torch.where(use2, cand2, cand1), 0)
    del cand1, cand2, ml1, ml2, cb1, cb2, use2
    profit = ml - _copy_nbytes(ml.clamp(min=4), offset.clamp(min=1))[0]
    # Lazy matching: a match gives way to a strictly more profitable one at
    # the next position.
    ml_next = torch.zeros_like(ml)
    ml_next[:, :-1] = ml[:, 1:]
    profit_next = torch.zeros_like(profit)
    profit_next[:, :-1] = profit[:, 1:]
    takeable = (ml >= 4) & ~((ml_next >= 4) & (profit_next > profit))
    del ml_next, profit_next
    cbytes = _copy_nbytes(ml, offset)[0]
    blen32 = blen.to(_I32)
    olen_a, *parse_a = _parse(takeable, profit, ml, cbytes, blen32, MIN_PROFIT)
    olen_b, *parse_b = _parse(takeable, profit, ml, cbytes, blen32, MIN_PROFIT_INCOMPRESSIBLE)
    # Both parses are valid streams; each row keeps the smaller.
    use_b = olen_b < olen_a
    olen = torch.where(use_b, olen_b, olen_a)
    chosen = [torch.where(use_b[:, None], b, a) for a, b in zip(parse_a, parse_b)]
    del parse_a, parse_b
    return _emit(blocks, olen, *chosen, ml, offset), olen.to(_I32)


def rows_per_chunk(width: int, device) -> int:
    """Rows of ``width`` bytes encoded together on ``device`` under
    ``CHUNK_BYTES``."""
    return max(1, CHUNK_BYTES[torch.device(device).type] // (ROW_BYTES_PER_BYTE * width))


def encode_blocks(blocks: torch.Tensor, blens: torch.Tensor, min_profit: int | None = None):
    """Encode B blocks into headerless tag streams on the device of
    ``blocks``; see the module docstring. ``min_profit`` is not read.
    Returns (out uint8[B, BLOCK_MAX_OUT], olens int32[B]). Raises ValueError
    on a row with ``blens`` outside [0, W - ENC_PAD]."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"blocks must be uint8[B, W], got {blocks.dtype}{list(blocks.shape)}")
    b, w = blocks.shape
    if tuple(blens.shape) != (b,) or blens.device != blocks.device:
        raise ValueError(f"blens must be [{b}] on {blocks.device}, got {list(blens.shape)} on {blens.device}")
    if not ENC_PAD < w <= (1 << 16) + ENC_PAD:
        raise ValueError(f"block rows must be {ENC_PAD + 1} to {(1 << 16) + ENC_PAD} bytes wide, got {w}")
    if b and bool(((blens < 0) | (blens > w - ENC_PAD)).any()):
        raise ValueError(f"need 0 <= blens <= W - {ENC_PAD} = {w - ENC_PAD}")
    out = torch.empty((b, BLOCK_MAX_OUT), dtype=torch.uint8, device=blocks.device)
    olens = torch.empty(b, dtype=_I32, device=blocks.device)
    step = rows_per_chunk(w, blocks.device)
    for lo in range(0, b, step):
        out[lo : lo + step], olens[lo : lo + step] = _encode_rows(blocks[lo : lo + step], blens[lo : lo + step],
                                                                  MATCH_CAP)
    return out, olens
