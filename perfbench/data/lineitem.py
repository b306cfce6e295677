"""TPC-H ``lineitem`` rows as Spark serializes them for a shuffle.

Each row is a Spark ``UnsafeRow`` of the table's 16 columns: one 8-byte
null-bit word, one 8-byte slot a field (longs; decimal(12,2) as its
unscaled long; ints and dates, as days since 1970, zero-extended; a string
as its offset from the row's start << 32 | its length), then the strings'
bytes in field order, each padded with zeros to a word. A row goes out as
``UnsafeRowSerializer`` writes it: its length as a big-endian int, then its
bytes. The rows follow dbgen's value rules (TPC-H 2.x, 4.2.3) at the
configuration's scale factor, orders in key order from the configuration's
first order on, drawn from the configuration's table seed: every seed
gets the same table, and the seed deals its blocks out among the batches.
``l_comment`` is a seeded slice of a text pool made by the spec's grammar
(4.2.2.10) from word lists the configuration lists under ``assumed``, each
template and word equally likely where dbgen weights them (the
configuration's ``l_comment_weights``, ``equal``, listed under ``reduced``).

Made on ``device`` with a ``torch.Generator`` there, in chunks of orders.
"""

from __future__ import annotations

import numpy as np
import torch

NOUNS = ("foxes ideas theodolites pinto_beans instructions dependencies excuses platelets asymptotes courts "
         "dolphins multipliers sauternes warthogs frets dinos attainments somas Tiresias' patterns forges braids "
         "hockey_players frays warhorses dugouts notornis epitaphs pearls tithes waters orbits gifts sheaves "
         "depths sentiments decoys realms pains grouches escapades").split()
VERBS = ("sleep wake are cajole haggle nag use boost affix detect integrate maintain nod was lose sublate solve "
         "thrash promise engage hinder print x-ray breach eat grow impress mold poach serve run dazzle snooze doze "
         "unwind kindle play hang believe doubt").split()
ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged daring brave stealthy "
              "permanent enticing idle busy regular final ironic even bold silent").split()
ADVERBS = ("sometimes always never furiously slyly carefully blithely quickly fluffily slowly quietly ruthlessly "
           "thinly closely doggedly daringly bravely stealthily permanently enticingly idly busily regularly "
           "finally ironically evenly boldly silently").split()
PREPOSITIONS = ("about above according_to across after against along alongside_of among around at atop before "
                "behind beneath beside besides between beyond by despite during except for from in_place_of "
                "inside instead_of into near of on outside over past since through throughout to toward under "
                "until up upon without with within").split()
AUXILIARIES = ("do may might shall will would can could should ought_to must will_have_to shall_have_to "
               "could_have_to should_have_to must_have_to need_to try_to").split()
TERMINATORS = (".", ";", ":", "?", "!", "--")
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
SHIPMODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

START_DATE = 8035  # 1992-01-01, days since 1970-01-01
END_DATE = 10591  # 1998-12-31
CURRENT_DATE = 9298  # 1995-06-17
FIXED = 8 + 16 * 8  # the null-bit word and the 16 slots
VAR = 8 + 8 + 24 + 8 + 48  # the strings' room: flags, instruct, mode, comment
MIN_RECORD = 4 + FIXED + 8 + 8 + 8 + 8 + 16
ORDERS_A_CHUNK = 250_000


def _words(rng, words, n):
    return [w.replace("_", " ") for w in rng.choice(words, n)]


def text_pool(size: int, seed: int = 0) -> np.ndarray:
    """``size`` bytes of the spec's pseudo-text: sentences of noun phrases,
    verb phrases and prepositional phrases, each template equally likely,
    from a fixed seed as dbgen's pool is."""
    rng = np.random.default_rng(seed)
    parts: list[str] = []
    length = 0
    while length < size:
        n = 4096
        nouns, verbs = _words(rng, NOUNS, 3 * n), _words(rng, VERBS, n)
        adjs, advs = _words(rng, ADJECTIVES, 4 * n), _words(rng, ADVERBS, 3 * n)
        preps, auxs = _words(rng, PREPOSITIONS, 2 * n), _words(rng, AUXILIARIES, n)
        terms = rng.choice(TERMINATORS, n)
        np_kind, vp_kind, template = rng.integers(4, size=(3, n)), rng.integers(4, size=n), rng.integers(5, size=n)

        def noun_phrase(i, j):
            k = np_kind[j % 3, i]
            noun = nouns[3 * i + j]
            return [noun, f"{adjs[4 * i + j]} {noun}", f"{adjs[4 * i + j]}, {adjs[4 * i + 3]} {noun}",
                    f"{advs[3 * i + j]} {adjs[4 * i + j]} {noun}"][k]

        for i in range(n):
            verb = [verbs[i], f"{auxs[i]} {verbs[i]}", f"{verbs[i]} {advs[3 * i + 2]}",
                    f"{auxs[i]} {verbs[i]} {advs[3 * i + 2]}"][vp_kind[i]]
            pp = [f"{preps[2 * i + j]} the {noun_phrase(i, 1 + j)}" for j in range(2)]
            subject = noun_phrase(i, 0)
            words = [[subject, verb], [subject, verb, pp[0]], [subject, verb, noun_phrase(i, 1)],
                     [subject, pp[0], verb, noun_phrase(i, 2)], [subject, pp[0], verb, pp[1]]][template[i]]
            sentence = " ".join(words) + terms[i] + " "
            parts.append(sentence)
            length += len(sentence)
    return np.frombuffer("".join(parts).encode()[:size], np.uint8).copy()


def _table(strings, width: int) -> torch.Tensor:
    t = np.zeros((len(strings), width), np.uint8)
    for i, s in enumerate(strings):
        t[i, : len(s)] = np.frombuffer(s.encode(), np.uint8)
    return torch.from_numpy(t)


def _pad8(n):
    return (n + 7) // 8 * 8


def records(first_order: int, n_orders: int, config: dict, pool: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """The serialized rows of ``n_orders`` orders from order index
    ``first_order`` on (u8, concatenated)."""
    dev = pool.device
    sf = config["scale_factor"]
    parts, supps = 200_000 * sf, 10_000 * sf

    def draw(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=dev)

    oidx = first_order + torch.arange(n_orders, device=dev)
    okey = oidx // 8 * 32 + oidx % 8 + 1  # dbgen's sparse keys: 8 of each 32
    odate = draw(START_DATE, END_DATE - 151, n_orders)
    nlines = draw(1, 7, n_orders)
    order = torch.repeat_interleave(torch.arange(n_orders, device=dev), nlines)
    n = len(order)
    linenumber = torch.arange(n, device=dev) - (torch.cumsum(nlines, 0) - nlines)[order] + 1
    orderdate = odate[order]
    partkey = draw(1, parts, n)
    suppkey = (partkey + draw(0, 3, n) * (supps // 4 + (partkey - 1) // supps)) % supps + 1
    quantity = draw(1, 50, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)  # p_retailprice in cents
    discount, tax = draw(0, 10, n), draw(0, 8, n)
    shipdate = orderdate + draw(1, 121, n)
    commitdate = orderdate + draw(30, 90, n)
    receiptdate = shipdate + draw(1, 30, n)
    returnflag = torch.where(receiptdate <= CURRENT_DATE,
                             torch.where(draw(0, 1, n) == 0, ord("R"), ord("A")), ord("N"))
    linestatus = torch.where(shipdate > CURRENT_DATE, ord("O"), ord("F"))
    instruct, mode = draw(0, 3, n), draw(0, 6, n)
    clen = draw(10, 43, n)
    coff = draw(0, len(pool) - 48, n)

    si_len = torch.tensor([len(s) for s in SHIPINSTRUCT], device=dev)[instruct]
    sm_len = torch.tensor([len(s) for s in SHIPMODE], device=dev)[mode]
    si_pad = _pad8(si_len)
    row_len = FIXED + 8 + 8 + si_pad + 8 + _pad8(clen)

    def string(offset, length):
        return offset << 32 | length

    fixed = torch.stack([
        torch.zeros_like(partkey), okey[order], partkey, suppkey, linenumber, quantity * 100, quantity * retail,
        discount, tax, string(torch.full_like(clen, FIXED), 1), string(torch.full_like(clen, FIXED + 8), 1),
        shipdate, commitdate, receiptdate, string(FIXED + 16 + 0 * clen, si_len),
        string(FIXED + 16 + si_pad, sm_len), string(FIXED + 24 + si_pad, clen),
    ], dim=1).contiguous().view(torch.uint8)

    var = torch.zeros((n, VAR), dtype=torch.uint8, device=dev)
    var[:, 0] = returnflag.to(torch.uint8)
    var[:, 8] = linestatus.to(torch.uint8)
    var[:, 16:40] = _table(SHIPINSTRUCT, 24).to(dev)[instruct]
    var.scatter_(1, 16 + si_pad[:, None] + torch.arange(8, device=dev), _table(SHIPMODE, 8).to(dev)[mode])
    cols = torch.arange(48, device=dev)
    comment = pool[coff[:, None] + cols] * (cols < clen[:, None])
    var.scatter_(1, 24 + si_pad[:, None] + cols, comment)

    size = torch.stack([(row_len >> s) & 0xFF for s in (24, 16, 8, 0)], dim=1).to(torch.uint8)
    rec = torch.cat([size, fixed, var], dim=1)
    return rec[torch.arange(rec.shape[1], device=dev) < 4 + row_len[:, None]]


def table(config: dict, device: torch.device) -> torch.Tensor:
    """u8[blocks, block_size]: serialized ``lineitem`` rows from the
    configuration's first order on, cut into blocks regardless of row ends,
    drawn on ``device`` from the configuration's table seed, as dbgen's
    table is fixed for a scale factor."""
    if config["l_comment_weights"] != "equal":
        raise ValueError(f"l_comment_weights {config['l_comment_weights']!r}: only 'equal' is made here")
    size = config["block_size"]
    total = config["blocks_per_batch"] * config["resident_batches"] * size
    g = torch.Generator(device=device)
    g.manual_seed(config["table_seed"])
    pool = torch.from_numpy(text_pool(config["text_pool_bytes"])).to(device)
    per_order = min(ORDERS_A_CHUNK, total // MIN_RECORD + 1)
    first = config["first_order"]
    out, have = [], 0
    while have < total:
        out.append(records(first, per_order, config, pool, g))
        have += len(out[-1])
        first += per_order
    return torch.cat(out)[:total].view(-1, size)


def generate(config: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The table's blocks dealt out among the batches in an order drawn
    from ``seed``."""
    blocks = table(config, device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return blocks[torch.randperm(len(blocks), generator=g, device=device)]
