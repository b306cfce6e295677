"""Plain torch versions of the round-4 probe kernels P1-P6.

The counterparts of the Pallas kernels of ``benchmarks/exp_vector_walk.py``,
which measured the primitives that the decoder's walk and drains are built
from. Each function computes what its kernel body computes, bit for bit, in
the reference's layouts, on tensors of any device; ``ops/cuda_probes.py``
holds the CUDA kernels against them. The knob that scales a probe's work
(the reference reads it from SMEM) is a Python int here.

- ``chain``: P1, ``reps`` dependent select steps on an int32[G, 8, 128]
  state (``_chain_kernel`` on axis 0 or 1, ``_alu_chain_kernel``,
  ``_multi_chain_kernel`` by gather or by reduce).
- ``walk8``: P2, 8 tag walks in lockstep per group (``_walk8_kernel``).
- ``walk_scalar``: P3, one tag walk per block (``_walk_scalar_kernel``).
- ``drain``: P4, masked row stores of records, 8 at a time by gather or by
  log-roll, or one by one (``_drain8_kernel``, ``_drain_serial_kernel``).
- ``scalar_loop``: P5, a scalar loop (``_scalar_loop_kernel``).
- ``when_drain``: P6, a drain with its second store always, under a
  predicate, or never (``_when_drain_kernel``).

int32 arithmetic wraps as in JAX; ``>>`` is arithmetic. Output positions
that no store reaches hold ``INT_MIN``, which is what the reference's
uninitialised outputs hold in interpret mode, so whole arrays compare. A
dynamic row or word index is clamped into its array, as JAX clamps one.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128
R_ROWS = 320  # command rows of 128 positions per walked block
T_TILES = 96  # record tiles per P2 group
NREC = 4096  # P4's records
NSRC = 512  # P4's source rows
NCP = R_ROWS * LANES  # command positions per block
WHEN_RECORDS = 4096  # P6's records, walked in passes of 512 groups of 8
WHEN_SRC_ROWS = 260
WHEN_OUT_ROWS = 504
INT_MIN = -(1 << 31)
# P2's bursts of 4 steps per row. A walk whose every tag advances at least
# one position leaves a row of 128 positions within 128 steps, so the cap
# changes no result of a walk that ends; a tag that advances 0 (the stall
# of the reference's synthetic data) then ends the row at the cap, where
# the reference kernel never ends.
MAX_BURSTS = 32
# P5's variants, in the reference's order: (label, work, unroll, cond, chain).
SCALAR_VARIANTS = [
    ("work4 U=1", 4, 1, False, False),
    ("work4 U=8", 4, 8, False, False),
    ("work16 U=1", 16, 1, False, False),
    ("work16 U=8", 16, 8, False, False),
    ("work4+cond U=1", 4, 1, True, False),
    ("work4+cond U=8", 4, 8, True, False),
    ("work4+chain U=8", 4, 8, False, True),
    ("work4+chain U=1", 4, 1, False, True),
]
CHAIN_MODES = ("axis0", "axis1", "alu", "gather", "reduce")
DRAIN_MODES = ("gather", "logroll", "serial")
WHEN_MODES = ("always", "when", "none")


def synth_cmds(nblocks: int, seed: int = 0, max_advance: int = 8):
    """Synthetic tag chains, as the reference's ``synth_cmds``: (cmds
    int32[nblocks, NCP], tags int64[nblocks]). Random 11-bit words, with the
    chain's positions overwritten by words whose bits 0-2 are the advance
    ``cx``, bit 3 the literal flag and bits 4-10 a length. Advances are drawn
    from 2..max_advance; the default, 8, draws the reference's arrays from
    the same seed. A copy of advance 8 stores ``cx = 8``, which the walks
    read as ``8 & 7 = 0``: such a tag does not move the walk on."""
    rng = np.random.default_rng(seed)
    cmds = rng.integers(0, 1 << 11, (nblocks, NCP), np.int64)
    tags = np.zeros(nblocks, np.int64)
    for b in range(nblocks):
        adv = rng.integers(2, max_advance + 1, NCP // 2)
        lit = rng.integers(0, 2, NCP // 2)
        pos, words = [], []
        ip = i = 0
        while ip < NCP:
            a, lt = int(adv[i]), int(lit[i])
            if lt:
                cx = max(a - 4, 1)
                ln = a - cx
            else:
                cx = a
                ln = int(rng.integers(4, 65))
            pos.append(ip)
            words.append(cx | (lt << 3) | (ln << 4))
            ip += cx + (ln if lt else 0)
            i += 1
        cmds[b, pos] = words
        tags[b] = len(pos)
    return cmds.astype(np.int32), tags


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2**32 into int32."""
    return (((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """int32 sum over the last axis, wrapping, keeping the axis."""
    return _wrap32(t.to(torch.int64).sum(-1, keepdim=True))


def _lanes(device) -> torch.Tensor:
    return torch.arange(LANES, dtype=torch.int32, device=device)


# ------------------------------------------------------------------ P1


def chain(knob: int, x: torch.Tensor, mode: str) -> torch.Tensor:
    """P1: ``knob`` steps of one chain mode on x int32[G, 8, 128].

    - ``axis0``, ``axis1``: ``_chain_kernel``, which selects along axis 0 or
      1 of the 3-D block (G, then the 8 sublanes) at index ``x & 7`` or
      ``x & 127``, plus one. An index past the axis reads ``INT_MIN``, as
      ``jnp.take_along_axis`` fills it.
    - ``alu``: ``_alu_chain_kernel``, ``((x & 127) ^ x) + 1``.
    - ``gather``, ``reduce``: ``_multi_chain_kernel``: each of the G chains
      adds ``(w & 7) + 1``, where w is ``window[s, x & 127]`` for gather and,
      for reduce, the sum over lanes l of ``window[s, l]`` where the lane's
      own ``x & 127 == l`` (one value per sublane). ``window`` is x[0] as
      given.
    """
    if mode not in CHAIN_MODES:
        raise ValueError(f"chain mode must be one of {CHAIN_MODES}, got {mode!r}")
    x = x.clone()
    g = x.shape[0]
    lane = _lanes(x.device)
    window = x[0].clone()
    fill = torch.full_like(x, INT_MIN)
    for _ in range(knob):
        if mode == "alu":
            x = ((x & 127) ^ x) + 1
        elif mode in ("axis0", "axis1"):
            axis = 0 if mode == "axis0" else 1
            idx = (x & (7 if axis == 0 else 127)).long()
            inside = idx < x.shape[axis]
            sel = torch.gather(x, axis, torch.where(inside, idx, 0))
            x = torch.where(inside, sel, fill) + 1
        elif mode == "gather":
            w = torch.gather(window.expand(g, 8, LANES), 2, (x & 127).long())
            x = x + (w & 7) + 1
        else:
            w = _lane_sum(torch.where(lane == (x & 127), window, 0))
            x = x + (w & 7) + 1
    return x


# ------------------------------------------------------------------ P2


def walk8(knob: int, clen: torch.Tensor, cmds: torch.Tensor):
    """P2: the first ``knob`` rows of 8 lockstep tag walks per group.

    clen int32[g, 8, 128] (each walk's length, per lane), cmds int32[g,
    R_ROWS, 8, 128] (walk s of a group reads sublane s of each row) ->
    (rec int32[g, T_TILES, 8, 128], meta int32[g, 1, 2]). Per row, bursts of
    4 steps run while any lane's ``ip`` lies in the row (at most
    ``MAX_BURSTS``); each active step appends ``ip | lit << 31`` at lane
    ``cur`` of its sublane's record tile, and moves ``ip`` by ``cx + lit *
    ln`` and ``op`` by ``ln``. After a row, if any cursor reached 96, the
    tile is stored at ``min(tile, T_TILES - 1)`` and cleared; the last tile
    is stored at the end. meta holds max(op) and max(cur). The reference's
    ``okacc`` is never read and is not computed.
    """
    g = cmds.shape[0]
    dev = cmds.device
    lane = _lanes(dev)
    zero = torch.zeros((g, 8, LANES), dtype=torch.int32, device=dev)
    ip, op, cur, acc = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    tile = torch.zeros(g, dtype=torch.int64, device=dev)
    rec = torch.full((g, T_TILES, 8, LANES), INT_MIN, dtype=torch.int32, device=dev)
    groups = torch.arange(g, device=dev)
    for r in range(knob):
        window = cmds[:, r]

        def active(ip):
            return ((ip.to(torch.int64) & 0xFFFFFFFF) >> 7 == r) & (ip < clen)

        # Every group runs the same bursts: in a group with no lane in the
        # row they change nothing, as they would not run there.
        bursts = 0
        while bursts < MAX_BURSTS and bool(active(ip).any()):
            for _ in range(4):
                act = active(ip)
                w = _lane_sum(torch.where(lane == (ip & 127), window, 0))
                cx, lit, ln = w & 7, (w >> 3) & 1, (w >> 4) & 0x7F
                recw = torch.where(lit == 1, ip | INT_MIN, ip)
                acc = torch.where((lane == cur) & act, recw, acc)
                cur = cur + act.to(torch.int32)
                ip = ip + torch.where(act, cx + lit * ln, 0)
                op = op + torch.where(act, ln, 0)
            bursts += 1
        full = cur.amax(dim=(1, 2)) >= 96
        if bool(full.any()):
            rec[groups[full], tile[full].clamp(max=T_TILES - 1)] = acc[full]
            acc = torch.where(full[:, None, None], 0, acc)
            cur = torch.where(full[:, None, None], 0, cur)
            tile = tile + full.to(torch.int64)
    rec[groups, tile.clamp(max=T_TILES - 1)] = acc
    meta = torch.stack([op.amax(dim=(1, 2)), cur.amax(dim=(1, 2))], dim=1).reshape(g, 1, 2)
    return rec, meta


# ------------------------------------------------------------------ P3


def walk_scalar(knob: int, clen: torch.Tensor, cmds: torch.Tensor) -> torch.Tensor:
    """P3: one tag walk per block, all blocks at once.

    clen int32[n, 1, 1], cmds int32[n, 1, NCP] -> meta int32[n, 1, 2] =
    (op, t). ``knob * NCP // 5 // 16 + 1`` rounds of 16 steps; a step reads
    ``cmds[ip]`` (clamped), and while ``ip < clen`` moves ``ip`` by ``cx +
    lit * ln``, ``op`` by ``ln`` and ``t`` by one. The reference also stores
    each step's record in a scratch array that nothing reads.
    """
    n = cmds.shape[0]
    words = cmds.reshape(n, -1)
    cl = clen.reshape(n)
    ip = torch.zeros(n, dtype=torch.int32, device=cmds.device)
    op, t = ip.clone(), ip.clone()
    last = words.shape[1] - 1
    for _ in range(16 * (knob * NCP // 5 // 16 + 1)):
        w = torch.gather(words, 1, ip.clamp(0, last).long()[:, None])[:, 0]
        cx, lit, ln = w & 7, (w >> 3) & 1, (w >> 4) & 0x7F
        live = (ip < cl).to(torch.int32)
        ip = ip + live * (cx + lit * ln)
        op = op + live * ln
        t = t + live
    return torch.stack([op, t], dim=1).reshape(n, 1, 2)


# ------------------------------------------------------------------ P4, P6


def _ordered_stores(out: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor, masks: torch.Tensor):
    """Apply masked row stores ``out[rows[i]] = vals[i] where masks[i]`` in
    order of i, so that a later store to the same position wins."""
    if rows.numel() == 0:
        return out
    nrows = out.shape[0]
    rows = rows.long().clamp(0, nrows - 1)
    seq = torch.arange(rows.numel(), device=out.device)[:, None].expand(-1, LANES)
    last = torch.full((nrows, LANES), -1, dtype=torch.int64, device=out.device)
    last.scatter_reduce_(0, rows[:, None].expand(-1, LANES), torch.where(masks, seq, -1), "amax")
    hit = last >= 0
    picked = torch.gather(vals, 0, last.clamp(min=0))
    return torch.where(hit, picked, out)


def _roll(x: torch.Tensor, shift) -> torch.Tensor:
    """Rotate the lanes right: out[..., l] = x[..., (l - shift) & 127], with
    ``shift`` an int or a tensor that broadcasts against x."""
    src = (_lanes(x.device) - shift) & (LANES - 1)
    return torch.gather(x, -1, src.long().expand_as(x))


def _var_roll(tile: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The reference's ``_var_roll``: 7 stages, each rolling right by 2**k
    where bit k of the lane's own shift is set."""
    x = tile
    for k in range(7):
        x = torch.where(((shift >> k) & 1) == 1, torch.roll(x, 1 << k, dims=-1), x)
    return x


def _fields(f: torch.Tensor):
    return f & 127, (f >> 7) & 127, (f >> 14) & 127, (f >> 21) & 0x7F


def drain(knob: int, q0: torch.Tensor, r: torch.Tensor, fld: torch.Tensor, src: torch.Tensor, mode: str):
    """P4: drain ``knob`` records of src int32[NSRC, 128] into out
    int32[NSRC + 8, 128].

    q0, r int32[NREC] are each record's source and output row; fld
    int32[NREC // 8, 8, 128] holds its fields (shift, ph, lo, n in bits 0-6,
    7-13, 14-20, 21-27), per lane. Records are stored in order.

    - ``gather``, ``logroll``: ``_drain8_kernel``, 8 records a group
      (``knob // 8`` groups): z is row ``q0`` rotated per lane, left by
      ``shift`` (gather: ``tile[(l + shift) & 127]``) or right by it
      (logroll: 7 stages of ``pltpu.roll``); ``z + ph`` is stored where
      ``lo <= l < lo + n``.
    - ``serial``: ``_drain_serial_kernel``, one record at a time, with the
      fields of lane 0: rows ``q0``, ``q0 + 1``, ``q0 + 2`` merged at ``ph``
      and rotated right by ``shift`` go to rows ``r`` (where ``lo <= l < lo
      + n``) and ``r + 1`` (where ``l < lo + n - 128``).
    """
    if mode not in DRAIN_MODES:
        raise ValueError(f"drain mode must be one of {DRAIN_MODES}, got {mode!r}")
    out = torch.full((src.shape[0] + 8, LANES), INT_MIN, dtype=torch.int32, device=src.device)
    lane = _lanes(src.device)
    last = src.shape[0] - 1
    if mode != "serial":
        nrec = knob // 8 * 8
        tile = src[q0[:nrec].long().clamp(0, last)]
        shift, ph, lo, n = _fields(fld[: nrec // 8].reshape(nrec, LANES))
        if mode == "gather":
            z = torch.gather(tile, 1, ((lane + shift) & 127).long())
        else:
            z = _var_roll(tile, shift)
        keep = (lane >= lo) & (lane < lo + n)
        return _ordered_stores(out, r[:nrec], torch.where(keep, z + ph, 0), keep)
    t = torch.arange(knob, device=src.device)
    q = q0[:knob].long()
    shift, ph, lo, n = (v[:, None] for v in _fields(fld.reshape(-1, 8, LANES)[t // 8, t % 8, 0]))
    # q0 + 1 and q0 + 2 are int32 sums in the reference: they wrap before the clamp.
    a, b, c = (src[((q + k + (1 << 31)) % (1 << 32) - (1 << 31)).clamp(0, last)] for k in range(3))
    sel = lane >= ph
    m = _roll(torch.where(sel, a, b), shift)
    m2 = _roll(torch.where(sel, b, c), shift)
    keep = (lane >= lo) & (lane < lo + n)
    k2 = lane < lo + n - LANES
    rows = torch.stack([r[:knob], r[:knob] + 1], 1).reshape(-1)
    return _ordered_stores(
        out, rows, torch.stack([m, m2], 1).reshape(-1, LANES), torch.stack([keep, k2], 1).reshape(-1, LANES)
    )


def when_drain(knob: int, q: torch.Tensor, r: torch.Tensor, src: torch.Tensor, mode: str) -> torch.Tensor:
    """P6: ``knob // 8`` groups of 8 records, record ``(g % 512) * 8 + k``,
    into out int32[WHEN_OUT_ROWS, 128].

    q, r int32[WHEN_RECORDS]: lo = q & 127 and n = (q >> 7) & 63; rows
    ``q & 255`` and the next of src int32[WHEN_SRC_ROWS, 128], merged at lo
    and rotated right by lo, go to row r where ``lo <= l < lo + n``; the
    second store, the other merge to row r + 1 where ``l < lo + n - 128``,
    is issued always, only where ``lo + n > 128`` (``when``: the same
    result), or never (``none``).
    """
    if mode not in WHEN_MODES:
        raise ValueError(f"when_drain mode must be one of {WHEN_MODES}, got {mode!r}")
    out = torch.full((WHEN_OUT_ROWS, LANES), INT_MIN, dtype=torch.int32, device=src.device)
    # One pass over the records leaves what any number of whole passes
    # leaves, but the stores are applied as the kernel issues them.
    groups = torch.arange(knob // 8, device=src.device)
    t = ((groups % (WHEN_RECORDS // 8))[:, None] * 8 + torch.arange(8, device=src.device)).reshape(-1)
    qt, rr = q[t], r[t]
    lane = _lanes(src.device)
    lo, n = (qt & 127)[:, None], ((qt >> 7) & 63)[:, None]
    base = (qt & 255).long()
    a, b = src[base], src[base + 1]
    sel = lane >= lo
    m = _roll(torch.where(sel, a, b), lo)
    keep = (lane >= lo) & (lane < lo + n)
    if mode == "none":
        return _ordered_stores(out, rr, m, keep)
    m2 = _roll(torch.where(sel, b, a), lo)
    k2 = lane < lo + n - LANES
    rows = torch.stack([rr, rr + 1], 1).reshape(-1)
    return _ordered_stores(
        out, rows, torch.stack([m, m2], 1).reshape(-1, LANES), torch.stack([keep, k2], 1).reshape(-1, LANES)
    )


def xor_words(x: torch.Tensor) -> torch.Tensor:
    """The XOR of the words of x int32[N] -> int32[1]: what the one-block
    read of ``cuda_probes.l2_read`` computes (not a probe; it measures the
    rate at which one SM takes words in from L2)."""
    v = x.reshape(-1)
    while v.numel() > 1:
        if v.numel() % 2:
            v = torch.cat([v, v.new_zeros(1)])
        v = v[: v.numel() // 2] ^ v[v.numel() // 2:]
    return v.reshape(1).clone() if v.numel() else x.new_zeros(1)


# ------------------------------------------------------------------ P5


def _i32(v: int) -> int:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def scalar_loop(knob: int, x: torch.Tensor, work: int, unroll: int, cond: bool, chain: bool) -> torch.Tensor:
    """P5: ``_scalar_loop_kernel`` -> int32[1]. While ``ip < knob``, run
    ``unroll`` steps; a step adds ``x[(ip + x[(ip + x[ip & 1023]) & 1023])
    & 1023]`` to acc (``chain``), applies ``acc = (acc ^ (acc >> 1)) + 1``
    ``work`` times, adds 2 to an even acc and 3 to an odd one (``cond``),
    and moves ip on by one. A walk on host ints."""
    xs = x.cpu().tolist()
    ip = acc = 0
    while ip < knob:
        for _ in range(unroll):
            if chain:
                v1 = xs[ip & 1023]
                v2 = xs[_i32(ip + v1) & 1023]
                acc = _i32(acc + xs[_i32(ip + v2) & 1023])
            for _ in range(work):
                acc = _i32((acc ^ (acc >> 1)) + 1)
            if cond:
                acc = _i32(acc + (2 if acc & 1 == 0 else 3))
            ip = _i32(ip + 1)
    return torch.tensor([acc], dtype=torch.int32, device=x.device)
