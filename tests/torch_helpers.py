"""Helpers shared by the tests that hold snappy_tpu_torch against snappy_tpu.

They live here and not in the port, because the port must not import
snappy_tpu.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

import snappy_tpu_torch.core.config as port_config
from snappy_tpu.core import config as ref_config
from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu_torch.core import varint
from snappy_tpu_torch.native import runtime as nat

from conftest import read_testdata


def config_from_reference(cfg):
    """The port's FrameConfig or CodecConfig with the fields of a
    snappy_tpu.core.config.FrameConfig or CodecConfig."""
    for ref_cls, port_cls in (
        (ref_config.FrameConfig, port_config.FrameConfig),
        (ref_config.CodecConfig, port_config.CodecConfig),
    ):
        if isinstance(cfg, ref_cls):
            return port_cls(**dataclasses.asdict(cfg))
    raise TypeError(f"not a snappy_tpu config: {type(cfg).__name__}")


def patch_reference_k2(monkeypatch) -> None:
    """Make snappy_tpu encode with its Pallas block encoder, K2 (interpret
    mode on a CPU, ``contest=False``), wherever a TPU would select it: on a
    CPU host it would pick its XLA encoder, another parse. Frames go through
    ``parallel/host.py::block_encoder``, raw streams through
    ``encode_xla._best_encoder``."""
    import snappy_tpu.parallel.host as ref_host
    from snappy_tpu.core.config import DEFAULT_MIN_PROFIT
    from snappy_tpu.ops import encode_xla

    monkeypatch.setattr(ref_host, "block_encoder", lambda nb, bs, mp: _k2(bs, mp))
    monkeypatch.setattr(encode_xla, "_best_encoder", lambda nb: _k2(BLOCK_SIZE, DEFAULT_MIN_PROFIT))


def _k2(block_size, min_profit):
    from snappy_tpu.ops import pallas_encode

    return pallas_encode.encode_blocks_jit(block_size, True, min_profit, contest=False)


@pytest.fixture(scope="module")
def one_torch_thread():
    """The module's torch ops on one intra-op thread. The plain versions
    run many small ops; on a host busy with other test workers, a pool of
    threads a worker stalls them (a module took 18x its time alone)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_k2(monkeypatch):
    """snappy_tpu with K2 wherever a TPU would run it."""
    patch_reference_k2(monkeypatch)


@contextlib.contextmanager
def reference_mesh_k2_patched():
    """patch_reference_k2, and K2 on every shard of snappy_tpu's mesh path,
    while the block is open. ``distributed._sharded_encode`` looks the
    encoder up in ``ops.select.block_encoder`` when it traces, and keeps
    what it traced in an ``lru_cache``: that cache is cleared when the
    patch begins and again when it ends."""
    from snappy_tpu.core.config import DEFAULT_MIN_PROFIT
    from snappy_tpu.ops import select as ref_select
    from snappy_tpu.parallel import distributed as ref_distributed

    with pytest.MonkeyPatch.context() as mp:
        patch_reference_k2(mp)
        mp.setattr(ref_select, "block_encoder", lambda nb, bs, p=None: _k2(bs, DEFAULT_MIN_PROFIT if p is None else p))
        ref_distributed._sharded_encode.cache_clear()
        try:
            yield
        finally:
            ref_distributed._sharded_encode.cache_clear()


def native_block_streams(raw: bytes, block_size: int = BLOCK_SIZE) -> tuple[list[bytes], list[int]]:
    """Headerless tag streams of each block of ``raw`` from the port's
    native ``compress_rows``, and the blocks' lengths."""
    n = max(-(-len(raw) // block_size), 1)
    buf = np.zeros((n, block_size), np.uint8)
    blens = np.zeros(n, np.int32)
    for i in range(n):
        chunk = raw[i * block_size : (i + 1) * block_size]
        buf[i, : len(chunk)] = np.frombuffer(chunk, np.uint8)
        blens[i] = len(chunk)
    return nat.compress_rows(buf, blens, np.arange(n)), blens.tolist()


def pack(bodies: list[bytes], pad: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """Zero-padded uint8[B, C] batch (C = widest body + pad) and the clens."""
    width = max(len(b) for b in bodies) + pad
    comp = np.zeros((len(bodies), width), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    return comp, np.array([len(b) for b in bodies], np.int32)


def copy2(length, off):
    return bytes([0x02 | ((length - 1) << 2), off & 0xFF, off >> 8])


def copy1(length, off):
    return bytes([0x01 | ((length - 4) << 2) | ((off >> 8) << 5), off & 0xFF])


def lit(data):
    return bytes([(len(data) - 1) << 2]) + data


def rle(base: bytes, n: int, off: int) -> bytes:
    exp = bytearray(base)
    for _ in range(n):
        exp.append(exp[-off])
    return bytes(exp)


def synthetic_cases() -> list[tuple[str, bytes, int, bytes | None]]:
    """(id, body, ulen, expected bytes or None for corrupt) rows of the
    block decoders' battery beyond corpus blocks: copy chains that K3's
    prepass folds, the corrupt battery, wrong claimed lengths, a COPY_4, a
    trailing byte and a cut copy trailer. Expected as the port's decoder
    reads them."""
    cases = []
    base = bytes(range(37)) * 2
    body = lit(base[:60]) + lit(base[60:]) + copy2(64, 74) + copy2(64, 74) + copy2(60, 74) + copy2(14, 74)
    cases.append(("chain-64-64-60-rem", body, 276, rle(base, 202, 74)))
    base = b"abcdefghij" * 2
    cases.append(("chain-copy1-tail", lit(base) + copy2(64, 20) + copy1(8, 20), 92, rle(base, 72, 20)))
    base = bytes(range(60))
    exp = rle(rle(base, 64, 30), 64, 29)
    cases.append(("chain-different-offset", lit(base) + copy2(64, 30) + copy2(64, 29), 188, exp))
    body = lit(b"x") + copy2(64, 1) + copy2(64, 1) + copy2(64, 1) + copy2(33, 1)
    cases.append(("chain-rle-folded", body, 226, b"x" * 226))
    for k in (1, 2, 3, 5, 8):
        base = bytes((i * 7) & 0xFF for i in range(70))
        body = lit(base[:60]) + lit(base[60:]) + copy2(64, 70) * k + copy2(7, 70)
        cases.append((f"chain-odd-{k}", body, 70 + 64 * k + 7, rle(base, 64 * k + 7, 70)))
    corrupt = [
        ("offset-zero", bytes([0x12, 0x00, 0x00])),
        ("before-start", bytes([0x61, 0x09, 0x20, 0x00])),
        ("literal-overrun", bytes([39 << 2, 0x61, 0x62])),
        ("truncated-long-literal", bytes([0xF8])),
        ("truncated-copy", bytes([0x01])),
        ("copy4-wild-offset", bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 255, 255])),
    ]
    for cid, body in corrupt:
        cases.append((f"corrupt-{cid}", body, 64, None))
    (s,), _ = native_block_streams(b"A" * 1000)
    cases.append(("wrong-length-999", s, 999, None))
    cases.append(("wrong-length-1024", s, 1024, None))
    cases.append(("copy4", bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 0, 0]), 8, b"abcdabcd"))
    (s,), _ = native_block_streams(b"hello world " * 40)
    cases.append(("trailing-byte-00", s + b"\x00", 480, b"hello world " * 40))
    cases.append(("trailing-byte-01", s + b"\x01", 480, b"hello world " * 40))
    base = bytes(range(60))
    body = lit(base) + copy2(64, 30) + copy2(64, 30)
    cases.append(("truncated-copy-trailer", body[:-1], 188, None))
    return cases


def native_body(raw: bytes) -> bytes:
    """Headerless tag stream of ``raw`` from the native raw encoder."""
    c = nat.compress(raw)
    _, h = varint.parse32(np.frombuffer(c, np.uint8), 0)
    return c[h:]


def kernel_battery(out_size: int):
    """(tag stream, ulen) rows for the kernels' host emulations, ulen <=
    out_size: corpus slices and long blocks, RLE, the corrupt battery, wrong
    lengths, trailing bytes, damaged corpus slices and random bytes, all from
    one seed."""
    rng = np.random.default_rng(0)
    cases = []
    for name in ["html", "fireworks.jpeg", "alice29.txt", "kppkn.gtb", "urls.10K", "paper-100k.pdf"]:
        data = read_testdata(name)
        for _ in range(3):
            n = int(rng.integers(1, out_size))
            s = int(rng.integers(0, len(data) - n))
            cases.append((native_body(data[s : s + n]), n))
        (s,), (u,) = native_block_streams(data[:out_size], out_size)
        cases.append((s, u))
    for raw in (b"q" * 5000, b"ab" * 2000, b"abcdefg" * 700, bytes(range(256)) * 32):
        cases.append((native_body(raw), len(raw)))
    cases += [
        (bytes([0x12, 0x00, 0x00]), 64),  # copy offset 0
        (bytes([0x61, 0x09, 0x20, 0x00]), 64),  # copy reaches before the output start
        (bytes([39 << 2, 0x61, 0x62]), 64),  # literal overruns the input
        (bytes([0xF8]), 64),  # truncated long-form literal tag
        (bytes([0x01]), 64),  # truncated copy tag
        (bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 255, 255]), 64),  # COPY_4 wild offset
        (bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 0, 0]), 8),  # COPY_4
        (bytes([0x0C, 97, 98, 99, 100, 0x01, 4]), 8),  # COPY_1 from the very start
        (bytes([0x0C, 97, 98, 99, 100, 0x01, 5]), 8),  # COPY_1 one byte before the start
        (bytes([0xF0, 3]) + b"wxyz", 4),  # long-form literal, 1 length byte
        (bytes(range(60)).join([bytes([59 << 2]), bytes([0x02 | (63 << 2), 30])]), 124),  # cut COPY_2
        (b"", 0),
        (b"\x00", 0),
        (b"\x00a", 1),
    ]
    hello = native_body(b"hello world " * 40)
    cases += [(hello, 479), (hello, 481), (hello + b"\x00", 480), (hello + b"\x01", 480)]
    for b, u in list(cases[:22]):
        for _ in range(4):
            bb, k = bytearray(b), int(rng.integers(0, 4))
            if k == 0 and bb:
                bb[int(rng.integers(0, len(bb)))] = int(rng.integers(0, 256))
            elif k == 1 and bb:
                bb = bb[: int(rng.integers(0, len(bb)))]
            elif k == 2:
                bb += bytes([int(rng.integers(0, 256))])
            else:
                u = max(0, u + int(rng.integers(-3, 4)))
            cases.append((bytes(bb), min(u, out_size)))
    for _ in range(24):
        n = int(rng.integers(0, 64))
        cases.append((rng.integers(0, 256, n, dtype=np.uint8).tobytes(), int(rng.integers(0, 300))))
    return cases


def odd_width_batch(cases):
    """Rows of a width that is not a multiple of 16, so that the shared-memory
    staging meets rows aligned to 16 bytes and rows that are not."""
    width = max(len(b) for b, _ in cases) + 4
    width += 1 if width % 16 == 0 else 0
    comp = np.zeros((len(cases), width), np.uint8)
    for i, (b, _) in enumerate(cases):
        comp[i, : len(b)] = np.frombuffer(b, np.uint8)
    clens = np.array([len(b) for b, _ in cases], np.int32)
    ulens = np.array([u for _, u in cases], np.int32)
    return comp, clens, ulens


def plain_takes(row: bytes, min_profit: int) -> list[tuple[int, int]]:
    """The takes (position, match length) that the block encoder's parse
    makes in ``row``, from the plain version's candidates and its walk."""
    import torch

    from snappy_tpu_torch.ops import encode_torch

    n = len(row)
    block = np.zeros((1, n + encode_torch.ENC_PAD), np.uint8)
    block[0, :n] = np.frombuffer(row, np.uint8)
    d, m = encode_torch.candidate_takes(torch.from_numpy(block), torch.tensor([n]), min_profit)
    d, m = d[0].numpy(), m[0].numpy()
    takes, anchor = [], 0
    for ip in np.flatnonzero(d[: max(n - 3, 0)]).tolist():
        if ip < anchor:
            continue
        limit = n - ip
        k = int(m[ip])
        k = encode_torch._match_length(row, ip, ip - int(d[ip]), encode_torch.M_CAP, limit) if k >= encode_torch.M_CAP else min(k, limit)
        takes.append((ip, k))
        anchor = ip + k
    return takes
