"""TPC-H ``lineitem`` as Spark writes it to Parquet with Snappy: row groups
of Snappy-compressed pages, laid out as a file holds them.

The rows are ``lineitem.py``'s (its value rules, text pool and string
tables, imported): orders in key order from the configuration's first
order on, drawn from its table seed, so every seed gets the same table.
Spark's types: keys, decimal(12,2) (unscaled) and prices int64,
``l_linenumber`` and dates (days since 1970) int32, the rest strings.

Each column chunk is written as parquet-mr (parquet-java) writes a v1
chunk with its ``ParquetProperties`` defaults:

- a page closes at ``page_row_count_limit`` rows or once the writer's
  buffered bytes reach ``page_size`` (4 a value while dictionary-encoding,
  the page's PLAIN bytes once fallen back), checked after every row (a
  page cut by its bytes is followed by one that ends with the 20,000-row
  strip it began in, so that the row group's rows are cut into strips of
  all columns);
- every column is nullable, so every data page starts with its definition
  levels: a 4-byte length, then one RLE run of 1s (no value is null);
- a column chunk starts dictionary-encoded, as parquet-mr's
  ``FallbackValuesWriter`` over its dictionary writer: a dictionary page
  (the values PLAIN, in order of first appearance) comes first, and each
  data page holds a bit-width byte (enough bits for the dictionary as it
  stands when the page closes) and the indices in bit-packed runs of the
  RLE/bit-packed hybrid (parquet-format ``Encodings.md``), at most 63
  groups of 8 a run. The chunk falls back to PLAIN (int32 and int64
  little-endian, strings as a 4-byte length and their bytes) for good on
  the page whose values take the dictionary's PLAIN bytes past
  ``dictionary_page_size`` (checked on every value, so that page is PLAIN
  whole), or on its first page where that page's indices and the
  dictionary come to no fewer bytes than the page PLAIN
  (``isCompressionSatisfying``); the dictionary page then holds the
  entries the dictionary-encoded pages used, and is left out where none
  was;
- each page is one raw Snappy stream, as snappy-java writes it: the varint
  length, then the frozen encoder's parse (``encoder.py``, libsnappy's) of
  each 64 KiB fragment;
- each stream follows its page header, thrift compact (type, sizes, crc32
  of the stream, and the data or dictionary page header), which the
  program does not read.

A row group closes after the 20,000-row page strip with which its streams
and its dictionaries' PLAIN bytes reach ``block_size``
(``parquet.block.size``), its columns' chunks in schema order. Pages decode into one output, each at an offset rounded up to
16 bytes, in file order. ``generate`` makes ``resident_row_groups`` row
groups on the host and deals them into the batch order drawn from ``seed``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench import encoder
from perfbench.data import lineitem

FRAGMENT = 1 << 16  # snappy-java's (libsnappy's) block: each is parsed alone
OUT_ALIGN = 16  # each page's output offset is rounded up to this
MAX_RUN_GROUPS = 63  # parquet-mr's bit-packed runs: at most 63 groups of 8, a one-byte header
STRIPS_A_CALL = 8  # strips compressed in one call of the frozen encoder
DENSE_CODES = 1 << 24  # a dictionary whose value codes span less than this looks them up in a table
# Thrift enums of parquet-format.
DATA_PAGE, DICTIONARY_PAGE = 0, 2
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED = 0, 2, 3, 4

# (column, physical type): Spark's lineitem schema in order.
SCHEMA = [
    ("l_orderkey", "int64"), ("l_partkey", "int64"), ("l_suppkey", "int64"), ("l_linenumber", "int32"),
    ("l_quantity", "int64"), ("l_extendedprice", "int64"), ("l_discount", "int64"), ("l_tax", "int64"),
    ("l_returnflag", "string"), ("l_linestatus", "string"), ("l_shipdate", "int32"), ("l_commitdate", "int32"),
    ("l_receiptdate", "int32"), ("l_shipinstruct", "string"), ("l_shipmode", "string"), ("l_comment", "string"),
]


def columns(first_order: int, n_orders: int, config: dict, pool: torch.Tensor, g: torch.Generator) -> dict:
    """The columns of ``n_orders`` orders from order index ``first_order``
    on, by ``lineitem.records``'s rules and in its order of draws (so the
    same generator state gives the same values): numpy arrays, strings as
    codes (``l_returnflag`` and ``l_linestatus`` their byte, the instruct and
    mode their index into ``lineitem.SHIPINSTRUCT`` and ``SHIPMODE``,
    ``l_comment`` an offset and a length into the text pool)."""
    dev = pool.device
    sf = config["scale_factor"]
    parts, supps = 200_000 * sf, 10_000 * sf

    def draw(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=dev)

    oidx = first_order + torch.arange(n_orders, device=dev)
    okey = oidx // 8 * 32 + oidx % 8 + 1
    odate = draw(lineitem.START_DATE, lineitem.END_DATE - 151, n_orders)
    nlines = draw(1, 7, n_orders)
    order = torch.repeat_interleave(torch.arange(n_orders, device=dev), nlines)
    n = len(order)
    linenumber = torch.arange(n, device=dev) - (torch.cumsum(nlines, 0) - nlines)[order] + 1
    orderdate = odate[order]
    partkey = draw(1, parts, n)
    suppkey = (partkey + draw(0, 3, n) * (supps // 4 + (partkey - 1) // supps)) % supps + 1
    quantity = draw(1, 50, n)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    discount, tax = draw(0, 10, n), draw(0, 8, n)
    shipdate = orderdate + draw(1, 121, n)
    commitdate = orderdate + draw(30, 90, n)
    receiptdate = shipdate + draw(1, 30, n)
    returnflag = torch.where(receiptdate <= lineitem.CURRENT_DATE,
                             torch.where(draw(0, 1, n) == 0, ord("R"), ord("A")), ord("N"))
    linestatus = torch.where(shipdate > lineitem.CURRENT_DATE, ord("O"), ord("F"))
    instruct, mode = draw(0, 3, n), draw(0, 6, n)
    clen = draw(10, 43, n)
    coff = draw(0, len(pool) - 48, n)
    cols = {
        "l_orderkey": okey[order], "l_partkey": partkey, "l_suppkey": suppkey, "l_linenumber": linenumber,
        "l_quantity": quantity * 100, "l_extendedprice": quantity * retail, "l_discount": discount, "l_tax": tax,
        "l_returnflag": returnflag, "l_linestatus": linestatus, "l_shipdate": shipdate, "l_commitdate": commitdate,
        "l_receiptdate": receiptdate, "l_shipinstruct": instruct, "l_shipmode": mode,
        "l_comment_off": coff, "l_comment_len": clen,
    }
    return {k: v.cpu().numpy() for k, v in cols.items()}


class Table:
    """The table's rows from the configuration's first order on, drawn in
    chunks of orders as they are asked for."""

    def __init__(self, config: dict, device: torch.device):
        if config["l_comment_weights"] != "equal":
            raise ValueError(f"l_comment_weights {config['l_comment_weights']!r}: only 'equal' is made here")
        self.config = config
        self.g = torch.Generator(device=device)
        self.g.manual_seed(config["table_seed"])
        self.pool_t = torch.from_numpy(lineitem.text_pool(config["text_pool_bytes"])).to(device)
        self.pool = self.pool_t.cpu().numpy()
        self.next_order = config["first_order"]
        self.first = 0  # the row that cols starts at: rows before the last asked for are let go
        self.cols: dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return self.first + len(self.cols.get("l_orderkey", ()))

    def rows(self, lo: int, hi: int) -> dict:
        """Rows [lo, hi); ``lo`` at or after the last call's."""
        if lo < self.first:
            raise ValueError(f"row {lo} was let go (rows from {self.first} on are held)")
        while len(self) < hi:
            more = columns(self.next_order, lineitem.ORDERS_A_CHUNK, self.config, self.pool_t, self.g)
            self.next_order += lineitem.ORDERS_A_CHUNK
            if self.cols:
                cut, self.first = lo - self.first, lo
                self.cols = {k: np.concatenate([self.cols[k][cut:], v]) for k, v in more.items()}
            else:
                self.cols = more
        return {k: v[lo - self.first : hi - self.first] for k, v in self.cols.items()}


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def bit_pack(values: np.ndarray, width: int) -> bytes:
    """The values' low ``width`` bits, least significant first, in groups of
    8 (the last padded with zeros), as the hybrid's bit-packed runs hold
    them, without run headers."""
    n = -(-len(values) // 8) * 8
    v = np.zeros(n, "<u4")
    v[: len(values)] = values
    bits = np.unpackbits(v.view(np.uint8).reshape(n, 4), axis=1, bitorder="little")[:, :width]
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()


def hybrid_bit_packed(values: np.ndarray, width: int) -> bytes:
    """The RLE/bit-packed hybrid of ``values`` in bit-packed runs of at most
    63 groups: each run a varint header ((groups << 1) | 1), then its
    groups."""
    packed = bit_pack(values, width)
    groups = -(-len(values) // 8)
    out = bytearray()
    for g0 in range(0, groups, MAX_RUN_GROUPS):
        k = min(MAX_RUN_GROUPS, groups - g0)
        out += varint(k << 1 | 1)
        out += packed[g0 * width : (g0 + k) * width]
    return bytes(out)


def definition_levels(n: int) -> bytes:
    """A nullable column's levels for n values, none null: one RLE run of
    1s at bit width 1, behind its 4-byte length."""
    run = varint(n << 1) + b"\x01"
    return len(run).to_bytes(4, "little") + run


def zigzag(n: int) -> bytes:
    return varint((n << 1) ^ (n >> 63))


def compact_struct(fields: list[tuple[int, int, object]]) -> bytes:
    """A thrift compact struct: (field id, type, value) in id order, i32
    (type 5) or struct (12, value already encoded); then the stop byte."""
    out, last = bytearray(), 0
    for fid, kind, value in fields:
        out.append((fid - last) << 4 | kind)
        out += zigzag(value) if kind == 5 else value
        last = fid
    return bytes(out + b"\x00")


def page_header(kind: int, usize: int, csize: int, crc: int, values: int, encoding: int) -> bytes:
    if kind == DATA_PAGE:
        sub = compact_struct([(1, 5, values), (2, 5, encoding), (3, 5, RLE), (4, 5, BIT_PACKED)])
        tail = (5, 12, sub)
    else:
        tail = (7, 12, compact_struct([(1, 5, values), (2, 5, encoding)]))
    crc32 = crc - (1 << 32) if crc >= 1 << 31 else crc
    return compact_struct([(1, 5, kind), (2, 5, usize), (3, 5, csize), (4, 5, crc32), tail])


def plain(values: np.ndarray, kind: str, strings=None) -> bytes:
    """PLAIN encoding: int32 and int64 little-endian; a string as a 4-byte
    length and its bytes (``strings(values)`` gives (bytes, lengths))."""
    if kind == "int32":
        return values.astype("<i4").tobytes()
    if kind == "int64":
        return values.astype("<i8").tobytes()
    data, lens = strings(values)
    out = np.empty(len(lens) * 4 + len(data), np.uint8)
    at = np.cumsum(4 + lens) - (4 + lens)
    out[(at[:, None] + np.arange(4)).reshape(-1)] = lens.astype("<u4").view(np.uint8)
    body = np.ones(len(out), bool)
    body[(at[:, None] + np.arange(4)).reshape(-1)] = False
    out[body] = data
    return out.tobytes()


def plain_sizes(values: np.ndarray, kind: str, lengths=None) -> np.ndarray:
    """Each value's PLAIN bytes."""
    if kind == "int32":
        return np.full(len(values), 4)
    if kind == "int64":
        return np.full(len(values), 8)
    return 4 + lengths


@dataclass
class Page:
    column: str
    kind: int  # DATA_PAGE or DICTIONARY_PAGE
    encoding: int
    values: int
    raw: bytes  # the page's uncompressed bytes
    stream: bytes = b""  # its Snappy stream


@dataclass
class RowGroup:
    """A row group as a file holds it and as a reader decodes it."""

    data: np.ndarray  # u8: the column chunks, page headers and streams
    starts: np.ndarray  # i64[p]: each stream's offset in data
    clens: np.ndarray  # i32[p]
    ulens: np.ndarray  # i32[p]: each page's uncompressed bytes (its header's)
    out_starts: np.ndarray  # i64[p]
    out_len: int
    pages: np.ndarray  # u8[out_len]: the pages decoded, zeros between them
    rows: int
    columns: list = field(default_factory=list)  # each page's column


def compress_pages(pages: list[Page]) -> None:
    """Fill each page's stream: the varint length, then the frozen
    encoder's parse of each 64 KiB fragment."""
    frags, lens, owner = [], [], []
    for i, p in enumerate(pages):
        raw = np.frombuffer(p.raw, np.uint8)
        for lo in range(0, len(raw), FRAGMENT):
            frags.append(raw[lo : lo + FRAGMENT])
            lens.append(len(frags[-1]))
            owner.append(i)
    if frags:
        blocks = np.zeros((len(frags), FRAGMENT), np.uint8)
        for k, f in enumerate(frags):
            blocks[k, : len(f)] = f
        width = -(-encoder.max_compressed_length(FRAGMENT) // 16) * 16
        out, olens = encoder.compress_rows(blocks, np.asarray(lens, np.int32), width)
    parts: list[list[bytes]] = [[] for _ in pages]
    for k, i in enumerate(owner):
        parts[i].append(out[k, : olens[k]].tobytes())
    for p, chunks in zip(pages, parts):
        p.stream = varint(len(p.raw)) + b"".join(chunks)


class Column:
    """One column chunk's writer within a row group: dictionary-encoded
    until it falls back to PLAIN, and its dictionary so far."""

    def __init__(self, name: str, kind: str, table: Table, dictionary_page_size: int):
        self.name, self.kind, self.table = name, kind, table
        self.limit = dictionary_page_size
        self.dictionary = True  # still dictionary-encoding
        self.first_page = True
        self.used = 0  # the dictionary's entries when its last dictionary-encoded page closed
        self.order = np.zeros(0, np.int64)  # the dictionary's value codes, by id (order of first appearance)
        self.base = None  # while the codes span less than DENSE_CODES: code - base -> id (-1: not yet)
        self.lut = np.zeros(0, np.int64)
        self.sorted = np.zeros(0, np.int64)  # else the codes sorted, and their ids
        self.sorted_ids = np.zeros(0, np.int64)

    def truncate(self, size: int) -> None:
        """The dictionary as it stood at ``size`` entries."""
        if self.base is not None:
            self.lut[self.order[size:] - self.base] = -1
        self.order = self.order[:size]
        if self.base is None:
            rank = np.argsort(self.order, kind="stable")
            self.sorted, self.sorted_ids = self.order[rank], rank

    def ids(self, codes: np.ndarray) -> np.ndarray:
        """The dictionary ids of ``codes``, new codes added in order of
        first appearance."""
        if not len(codes):
            return codes
        if not len(self.order):
            self.base = int(codes.min())
        if self.base is not None:
            lo, hi = min(self.base, int(codes.min())), max(self.base + len(self.lut), int(codes.max()) + 1)
            if hi - lo >= DENSE_CODES:
                self.base = None
                self.truncate(len(self.order))
            elif lo < self.base or hi > self.base + len(self.lut):
                lut = np.full(max(hi - lo, 2 * len(self.lut)), -1, np.int64)
                lut[self.base - lo : self.base - lo + len(self.lut)] = self.lut
                self.base, self.lut = lo, lut
        if self.base is not None:
            ids = self.lut[codes - self.base]
            miss = ids < 0
            if miss.any():
                new, first = np.unique(codes[miss], return_index=True)
                new = new[np.argsort(first)]
                self.lut[new - self.base] = len(self.order) + np.arange(len(new))
                self.order = np.concatenate([self.order, new])
                ids = self.lut[codes - self.base]
            return ids
        at = np.searchsorted(self.sorted, codes)
        known = self.sorted[np.minimum(at, len(self.sorted) - 1)] == codes if len(self.sorted) else np.zeros(
            len(codes), bool)
        if not known.all():
            new, first = np.unique(codes[~known], return_index=True)
            where = np.searchsorted(self.sorted, new)
            self.sorted_ids = np.insert(self.sorted_ids, where, len(self.order) + np.argsort(np.argsort(first)))
            self.sorted = np.insert(self.sorted, where, new)
            self.order = np.concatenate([self.order, new[np.argsort(first)]])
            at = np.searchsorted(self.sorted, codes)
        return self.sorted_ids[at]

    def codes(self, rows: dict) -> np.ndarray:
        if self.name == "l_comment":
            return rows["l_comment_off"].astype(np.int64) << 8 | rows["l_comment_len"]
        return rows[self.name].astype(np.int64)

    def strings(self, codes: np.ndarray):
        """(bytes, lengths) of string codes."""
        if self.name == "l_comment":
            off, lens = codes >> 8, codes & 0xFF
            idx = np.repeat(off - (np.cumsum(lens) - lens), lens) + np.arange(int(lens.sum()))
            return self.table.pool[idx], lens
        if self.name in ("l_returnflag", "l_linestatus"):
            return codes.astype(np.uint8), np.ones(len(codes), np.int64)
        table = lineitem.SHIPINSTRUCT if self.name == "l_shipinstruct" else lineitem.SHIPMODE
        words = [table[c].encode() for c in codes.tolist()]
        return np.frombuffer(b"".join(words), np.uint8), np.array([len(w) for w in words], np.int64)

    def sizes(self, codes: np.ndarray) -> np.ndarray:
        if self.kind != "string":
            return plain_sizes(codes, self.kind)
        if self.name == "l_comment":
            return 4 + (codes & 0xFF)
        if self.name in ("l_returnflag", "l_linestatus"):
            return np.full(len(codes), 5)
        table = lineitem.SHIPINSTRUCT if self.name == "l_shipinstruct" else lineitem.SHIPMODE
        return np.array([4 + len(w) for w in table])[codes]

    def pages(self, codes: np.ndarray, page_rows: int, page_size: int) -> list[Page]:
        """The data pages of ``codes`` (a strip of at most ``page_rows``),
        each cut where the writer's buffered bytes reach ``page_size``."""
        out, lo = [], 0
        while lo < len(codes):
            hi = lo + self.cut(codes[lo : lo + page_rows], page_size)
            out.append(self.page(codes[lo:hi]))
            lo = hi
        return out

    def cut(self, part: np.ndarray, page_size: int) -> int:
        """Rows of ``part`` in the next page: up to the row with which the
        writer's buffered bytes reach ``page_size``. A dictionary writer
        buffers 4 bytes a value (its ids as ints); once the chunk falls
        back, the PLAIN writer holds the page's values so far."""
        rows = np.arange(1, len(part) + 1)
        fall = 0
        if self.dictionary:
            may_pass = self.dictionary_bytes() + int(self.sizes(part).sum()) > self.limit
            fall = self.falls_back_at(part) if may_pass else len(part)
        buffered = 4 * rows
        if fall < len(part):
            buffered = np.where(rows <= fall, buffered, np.cumsum(self.sizes(part)))
        full = np.flatnonzero(buffered >= page_size)
        return int(full[0]) + 1 if len(full) else len(part)

    def falls_back_at(self, part: np.ndarray) -> int:
        """The row of ``part`` whose value takes the dictionary's PLAIN
        bytes past its page (``len(part)`` where none does); the
        dictionary is left as it was."""
        n0 = len(self.order)
        self.ids(part)
        new = self.order[n0:]
        over = np.flatnonzero(self.dictionary_bytes() - int(self.sizes(new).sum()) + np.cumsum(self.sizes(new))
                              > self.limit) if len(new) else []
        self.truncate(n0)
        return int(np.flatnonzero(part == new[over[0]])[0]) if len(over) else len(part)

    def page(self, codes: np.ndarray) -> Page:
        levels = definition_levels(len(codes))
        if self.dictionary:
            ids = self.ids(codes)
            width = max(len(self.order) - 1, 0).bit_length()
            body = bytes([width]) + hybrid_bit_packed(ids, width)
            size = self.dictionary_bytes()
            if size > self.limit or (self.first_page and len(body) + size >= int(self.sizes(codes).sum())):
                self.dictionary = False
                self.truncate(self.used)
            else:
                self.used, self.first_page = len(self.order), False
                return Page(self.name, DATA_PAGE, PLAIN_DICTIONARY, len(codes), levels + body)
        self.first_page = False
        return Page(self.name, DATA_PAGE, PLAIN, len(codes), levels + plain(codes, self.kind, self.strings))

    def dictionary_bytes(self) -> int:
        """The dictionary's PLAIN bytes as it stands."""
        return int(self.sizes(self.order).sum()) if len(self.order) else 0

    def dictionary_page(self) -> Page:
        return Page(self.name, DICTIONARY_PAGE, PLAIN_DICTIONARY, len(self.order),
                    plain(self.order, self.kind, self.strings))


def strips_until(cols: list[Column], table: Table, first_row: int, config: dict) -> tuple[list, int]:
    """The strips of pages from ``first_row`` on, compressed, up to the one
    with which their streams and the dictionaries' PLAIN bytes reach
    ``block_size``; and the row after it. Strips are compressed a few at a
    time; those past the last are dropped and the dictionaries put back as
    they stood after it."""
    rows_a_page = config["page_row_count_limit"]
    strips, size, hi = [], 0, first_row
    while True:
        batch = []
        for _ in range(STRIPS_A_CALL):
            rows = table.rows(hi, hi + rows_a_page)
            pages = [p for c in cols for p in c.pages(c.codes(rows), rows_a_page, config["page_size"])]
            hi += len(rows["l_orderkey"])
            batch.append((pages, hi, [c.used for c in cols], sum(c.dictionary_bytes() for c in cols)))
        compress_pages([p for pages, _, _, _ in batch for p in pages])
        for pages, end, used, dictionaries in batch:
            strips.append(pages)
            size += sum(len(p.stream) for p in pages)
            if size + dictionaries >= config["block_size"]:
                for c, n in zip(cols, used):
                    c.truncate(n)
                    c.used = n
                return strips, end


def row_group(table: Table, first_row: int, config: dict) -> tuple[RowGroup, int]:
    """The row group that starts at ``first_row``, and the row after it:
    each column's dictionary page where it has one, then its data pages."""
    cols = [Column(name, kind, table, config["dictionary_page_size"]) for name, kind in SCHEMA]
    strips, hi = strips_until(cols, table, first_row, config)
    dicts = {c.name: c.dictionary_page() for c in cols if c.used}
    compress_pages(list(dicts.values()))
    ordered = []
    for c in cols:
        if c.name in dicts:
            ordered.append(dicts[c.name])
        ordered += [p for strip in strips for p in strip if p.column == c.name]
    return lay_out(ordered, hi - first_row), hi


def lay_out(pages: list[Page], n_rows: int) -> RowGroup:
    """Pages in file order as a row group's bytes: each page header, then
    its stream; and their outputs end to end at 16-byte offsets."""
    buf, starts, out_starts, at = bytearray(), [], [], 0
    for p in pages:
        buf += page_header(p.kind, len(p.raw), len(p.stream), zlib.crc32(p.stream), p.values, p.encoding)
        starts.append(len(buf))
        buf += p.stream
        out_starts.append(at)
        at = -(-(at + len(p.raw)) // OUT_ALIGN) * OUT_ALIGN
    out = np.zeros(at, np.uint8)
    for p, o in zip(pages, out_starts):
        out[o : o + len(p.raw)] = np.frombuffer(p.raw, np.uint8)
    return RowGroup(
        data=np.frombuffer(bytes(buf), np.uint8), starts=np.asarray(starts, np.int64),
        clens=np.asarray([len(p.stream) for p in pages], np.int32),
        ulens=np.asarray([len(p.raw) for p in pages], np.int32),
        out_starts=np.asarray(out_starts, np.int64), out_len=at, pages=out, rows=n_rows,
        columns=[p.column for p in pages],
    )


def row_groups(config: dict, device: torch.device) -> list[RowGroup]:
    """The configuration's resident row groups in file order, from the
    table's first row on."""
    table = Table(config, device)
    groups, at = [], 0
    for _ in range(config["resident_row_groups"]):
        group, at = row_group(table, at, config)
        groups.append(group)
    return groups


def generate(config: dict, seed: int, device: torch.device) -> list[RowGroup]:
    """The resident row groups, dealt into the batch order drawn from
    ``seed``."""
    groups = row_groups(config, device)
    order = np.random.default_rng(seed).permutation(len(groups))
    return [groups[i] for i in order]
