"""The Parquet cell's pieces on the CPU: the generator's pages read back by
parquet-format's rules (Encodings.md's bit-packing, the 20,000-row and
byte cuts of a page, the dictionary fallback, the page headers), its rows
equal to the shuffle cell's rules, and the entry's judge, faults planted in
its results, and its control."""

import numpy as np
import pytest
import torch

from perfbench import faults, reference
from perfbench.data import lineitem
from perfbench.data import parquet_lineitem as pq
from perfbench.registry import Registry
from perfbench.run import run_cell
from perfbench.tests.helpers import tiny_copy
from perfbench.tests.test_perfbench_data import parse

REG = Registry()
CPU = torch.device("cpu")
SEED = 2**31 + 91


def small(**sizes):
    config = REG.config("parquet_lineitem")
    config.update(block_size=4096, page_row_count_limit=2000, resident_row_groups=2)
    config.update(sizes)
    return config


def varint(buf: bytes, at: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[at]
        at += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return n, at


def unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def compact(buf: bytes, at: int) -> tuple[dict, int]:
    """A thrift compact struct of i32 and struct fields: ({id: value}, end)."""
    fields, fid = {}, 0
    while buf[at]:
        head = buf[at]
        at += 1
        fid += head >> 4
        if head & 15 == 5:
            v, at = varint(buf, at)
            fields[fid] = unzigzag(v)
        else:
            fields[fid], at = compact(buf, at)
    return fields, at + 1


def unpack_hybrid(body: bytes, width: int, count: int) -> np.ndarray:
    """Values of the RLE/bit-packed hybrid (both run kinds)."""
    out, at = [], 0
    while len(out) < count:
        head, at = varint(body, at)
        if head & 1:
            n = (head >> 1) * width
            bits = np.unpackbits(np.frombuffer(body[at : at + n], np.uint8), bitorder="little")
            out += (bits.reshape(-1, width) << np.arange(width)).sum(axis=1).tolist() if width else [0] * (n * 8)
            at += n
        else:
            k = -(-width // 8)
            out += [int.from_bytes(body[at : at + k], "little")] * (head >> 1)
            at += k
    return np.asarray(out[:count])


def pages_of(group: pq.RowGroup):
    """(column, header fields, page bytes) of each page, from the row
    group's bytes: each header read from the end of the stream before it."""
    data, at = group.data.tobytes(), 0
    for col, start, clen in zip(group.columns, group.starts.tolist(), group.clens.tolist()):
        header, end = compact(data, at)
        assert end == start, "a page's stream follows its header"
        page = reference.decode_raw(data[start : start + clen])
        assert page is not None and len(page) == header[2] and header[3] == clen
        yield col, header, page
        at = start + clen
    assert at == len(data)


def decode_column(group: pq.RowGroup, column: str, kind: str) -> list:
    """A column chunk's values, read back from its pages."""
    pages = [(header, page) for col, header, page in pages_of(group) if col == column]
    return decode_pages([p for p in pages if p[0][1] == pq.DATA_PAGE], pages, kind)


def decode_pages(wanted, pages, kind: str) -> list:
    """The values of the data pages ``wanted`` (header, bytes) of a column
    chunk whose pages are ``pages``."""
    dictionary = None
    for header, page in pages:
        if header[1] == pq.DICTIONARY_PAGE:
            dictionary, _ = read_plain(page, 0, header[7][1], kind)
    values = []
    for header, page in wanted:
        n = header[5][1]
        (levels_len,) = np.frombuffer(page[:4], "<u4")
        assert unpack_hybrid(page[4 : 4 + levels_len], 1, n).tolist() == [1] * n  # none null
        at = 4 + int(levels_len)
        if header[5][2] == pq.PLAIN:
            got, at = read_plain(page, at, n, kind)
            assert at == len(page)
            values += got
        else:
            ids = unpack_hybrid(page[at + 1 :], page[at], n)
            assert ids.max() < 1 << page[at]
            values += [dictionary[i] for i in ids]
    return values


def read_plain(page: bytes, at: int, n: int, kind: str):
    if kind != "string":
        size = 4 if kind == "int32" else 8
        return np.frombuffer(page[at : at + n * size], f"<i{size}").tolist(), at + n * size
    out = []
    for _ in range(n):
        (k,) = np.frombuffer(page[at : at + 4], "<u4")
        out.append(page[at + 4 : at + 4 + k].decode())
        at += 4 + int(k)
    return out, at


def test_bit_packing_follows_encodings_md():
    # Encodings.md: values 0 to 7 at bit width 3 pack to 0x88 0xC6 0xFA.
    assert pq.bit_pack(np.arange(8), 3) == bytes([0x88, 0xC6, 0xFA])
    assert pq.hybrid_bit_packed(np.arange(8), 3) == bytes([0x03, 0x88, 0xC6, 0xFA])  # one group
    values = np.random.default_rng(1).integers(0, 1 << 11, 1000)
    packed = pq.hybrid_bit_packed(values, 11)
    assert packed[0] == 63 << 1 | 1  # runs of at most 63 groups
    assert unpack_hybrid(packed, 11, 1000).tolist() == values.tolist()
    assert pq.definition_levels(20_000) == bytes([4, 0, 0, 0]) + pq.varint(40_000) + b"\x01"


def test_columns_follow_the_shuffle_cells_rules():
    config = small()
    pool = torch.from_numpy(lineitem.text_pool(config["text_pool_bytes"]))
    ga, gb = torch.Generator(), torch.Generator()
    ga.manual_seed(5)
    gb.manual_seed(5)
    cols = pq.columns(config["first_order"], 300, config, pool, ga)
    rows = parse(lineitem.records(config["first_order"], 300, config, pool, gb).numpy().tobytes(), 300)
    text = pool.numpy()
    for i, row in enumerate(rows):
        okey, pkey, skey, line, qty, price, disc, tax, rflag, status, ship, commit, receipt, instr, mode, comment = row
        assert [cols[k][i] for k in ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
                                      "l_extendedprice", "l_discount", "l_tax")] == [okey, pkey, skey, line, qty,
                                                                                      price, disc, tax]
        assert [cols[k][i] for k in ("l_shipdate", "l_commitdate", "l_receiptdate")] == [ship, commit, receipt]
        assert (chr(cols["l_returnflag"][i]), chr(cols["l_linestatus"][i])) == (rflag, status)
        assert (lineitem.SHIPINSTRUCT[cols["l_shipinstruct"][i]], lineitem.SHIPMODE[cols["l_shipmode"][i]]) == (
            instr, mode)
        off, n = cols["l_comment_off"][i], cols["l_comment_len"][i]
        assert text[off : off + n].tobytes().decode() == comment


def encodings(group: pq.RowGroup) -> dict:
    """Each column's data pages' encodings, in order, from their headers."""
    out = {name: [] for name, _ in pq.SCHEMA}
    for col, header, _ in pages_of(group):
        if header[1] == pq.DATA_PAGE:
            out[col].append(header[5][2])
    return out


def test_pages_read_back_as_the_columns():
    config = small(page_row_count_limit=3000, dictionary_page_size=30_000)
    table = pq.Table(config, CPU)
    (group,) = pq.row_groups(dict(config, resident_row_groups=1), CPU)
    rows = table.rows(0, group.rows)
    assert group.rows == 3000  # one strip reaches 4,096 bytes
    for name, kind in pq.SCHEMA:
        got = decode_column(group, name, kind)
        col = pq.Column(name, kind, table, config["dictionary_page_size"])
        codes = col.codes(rows)
        if kind == "string":
            data, lens = col.strings(codes)
            want = [bytes(data[o : o + n]).decode() for o, n in zip(np.cumsum(lens) - lens, lens)]
        else:
            want = codes.tolist()
        assert got == want, name
    assert {pq.PLAIN, pq.PLAIN_DICTIONARY} == {e for es in encodings(group).values() for e in es}


def plain_bytes(values: list, kind: str) -> int:
    if kind == "string":
        return sum(4 + len(v.encode()) for v in values)
    return (4 if kind == "int32" else 8) * len(values)


def test_a_chunk_falls_back_to_plain_as_parquet_mr_does():
    # parquet-mr's FallbackValuesWriter, checked from the pages read back: a
    # chunk is dictionary-encoded until a page's values take the dictionary
    # past its page size (that page PLAIN whole), or its first page with the
    # dictionary comes to no fewer bytes than PLAIN; PLAIN for good after;
    # the dictionary page holds the entries the dictionary pages used.
    limit = 30_000
    config = small(page_row_count_limit=2000, dictionary_page_size=limit, block_size=800_000)
    (group,) = pq.row_groups(dict(config, resident_row_groups=1), CPU)
    seen = set()
    for name, kind in pq.SCHEMA:
        pages = [(header, page) for col, header, page in pages_of(group) if col == name]
        entries, dictionary, first, want = [], True, True, []
        for header, page in pages:
            if header[1] == pq.DICTIONARY_PAGE:
                continue
            n = header[5][1]
            values = decode_pages([(header, page)], pages, kind)
            if dictionary:
                known = set(entries)
                grown = entries + [v for v in dict.fromkeys(values) if v not in known]
                width = max(len(grown) - 1, 0).bit_length()
                body = 1 + len(pq.hybrid_bit_packed(np.zeros(len(values), np.int64), width))  # its length: n and width
                size = plain_bytes(grown, kind)
                if size > limit or (first and body + size >= plain_bytes(values, kind)):
                    dictionary = False
                else:
                    entries = grown
            first = False
            want.append(pq.PLAIN_DICTIONARY if dictionary else pq.PLAIN)
            assert len(values) == n
        assert encodings(group)[name] == want, name
        dict_pages = [page for header, page in pages if header[1] == pq.DICTIONARY_PAGE]
        if entries:
            assert read_plain(dict_pages[0], 0, len(entries), kind)[0] == entries, name
        assert len(dict_pages) == bool(entries), name
        seen.add((want[0], want[-1]))
    # Chunks dictionary-encoded throughout, PLAIN from their first page, and
    # falling back in mid-chunk.
    assert {(pq.PLAIN_DICTIONARY,) * 2, (pq.PLAIN,) * 2, (pq.PLAIN_DICTIONARY, pq.PLAIN)} <= seen


def test_a_page_closes_at_its_row_limit_or_its_bytes():
    config = small(page_row_count_limit=20_000, dictionary_page_size=1)
    (group,) = pq.row_groups(dict(config, resident_row_groups=1), CPU)
    assert group.rows == 20_000 and {e for es in encodings(group).values() for e in es} == {pq.PLAIN}
    sizes = {c: u for c, u in zip(group.columns, group.ulens.tolist())}
    assert sizes["l_orderkey"] == 8 + 8 * 20_000 and sizes["l_linenumber"] == 8 + 4 * 20_000
    assert group.columns.count("l_orderkey") == 1
    config = small(page_row_count_limit=20_000, page_size=100_000, dictionary_page_size=1)
    (group,) = pq.row_groups(dict(config, resident_row_groups=1), CPU)
    keys = [u for c, u in zip(group.columns, group.ulens.tolist()) if c == "l_orderkey"]
    assert keys == [len(pq.definition_levels(n)) + 8 * n for n in (12_500, 7_500)]  # 12,500 reach 100,000 bytes


def test_row_groups_close_at_block_size_and_lay_out_their_outputs():
    config = small(block_size=300_000)
    groups = pq.row_groups(config, CPU)
    for g in groups:
        data = [(c, n) for c, n, (_, header, _) in zip(g.columns, g.clens.tolist(), pages_of(g))
                if header[1] == pq.DATA_PAGE]
        dictionaries = sum(u for u, (_, header, _) in zip(g.ulens.tolist(), pages_of(g))
                           if header[1] == pq.DICTIONARY_PAGE)
        last_strip = sum({c: n for c, n in data}.values())  # each column's last page
        total = sum(n for _, n in data)
        assert total + dictionaries >= 300_000 > total - last_strip
        assert (g.out_starts % 16 == 0).all() and (np.diff(g.out_starts) >= g.ulens[:-1]).all()
        assert g.out_len >= int(g.out_starts[-1] + g.ulens[-1])
        for o, n, (col, header, page) in zip(g.out_starts.tolist(), g.ulens.tolist(), pages_of(g)):
            assert g.pages[o : o + n].tobytes() == page
    assert groups[0].rows % config["page_row_count_limit"] == 0


def test_the_seed_deals_the_same_row_groups():
    config = small()
    a, b = pq.generate(config, SEED, CPU), pq.generate(config, SEED, CPU)
    assert [g.data.tobytes() for g in a] == [g.data.tobytes() for g in b]
    base = [g.data.tobytes() for g in pq.row_groups(config, CPU)]
    for seed in (0, 1, 2, SEED):
        assert sorted(g.data.tobytes() for g in pq.generate(config, seed, CPU)) == sorted(base)


@pytest.fixture(scope="module")
def state():
    from perfbench.entries import decompress_streams as entry

    config = small(resident_row_groups=2)
    return entry, entry.prepare(pq.generate(config, SEED, CPU), config, {}, CPU)


def test_the_judge_counts_pages_wrong(state):
    entry, st = state
    result = entry.call(st, 0)
    assert entry.wrong_rows(st, 0, result) == 0
    assert entry.work(st, 0, result)["rows"] == len(st.groups[0].host["starts"])
    out, ok = (t.clone() for t in result)
    h = st.groups[0].host
    out[int(h["out_starts"][3])] ^= 1
    ok[7] = False
    assert entry.wrong_rows(st, 0, (out, ok)) == 2
    assert entry.wrong_rows(st, 0, (out[:-1], ok)) == len(h["starts"])
    assert entry.wrong_rows(st, 1, result) > 0  # another row group's pages


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_a_planted_fault_reads_false(state, fault):
    entry, st = state
    broken = faults.plant(fault, entry.call)
    wrong = sum(entry.wrong_rows(st, b, broken(st, b)) for b in range(entry.batches(st)))
    assert wrong > 0


def test_the_control_reads_wrong(state):
    entry, st = state
    wrong = [entry.wrong_rows(st, b, entry.control(st, b)) for b in range(entry.batches(st))]
    assert sum(wrong) > 0
    out, ok = entry.control(st, 0)
    assert ok.all()  # every stream is valid; only overlapping copies come out wrong


def test_a_broken_program_is_not_correct(tmp_path, monkeypatch):
    from snappy_tpu_torch.parallel import distributed

    reg = tiny_copy(tmp_path)
    whole = distributed.decompress_streams

    def altered(*args, **kwargs):
        out, ok = whole(*args, **kwargs)
        out = out.clone()
        out[args[4]] ^= 0x55  # the first byte of every page
        return out, ok

    monkeypatch.setattr(distributed, "decompress_streams", altered)
    result = run_cell("parquet_lineitem.decode", 2**33 + 7, 0.1, trace=False, registry=reg, device=CPU)
    assert not result["correct"] and result["checks"]["rows_wrong"]["value"] > 0
