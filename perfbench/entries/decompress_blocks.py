"""Decode cells: the program's batched block decoder with its rows resident.

Set-up cuts the configuration's blocks into rows, encodes each with the
frozen encoder (``encoder.py``) into a fixed-width stream row, and puts the
streams and their lengths on the device. A call decodes one resident batch
through ``snappy_tpu_torch.parallel.distributed.decompress_blocks`` over a
one-device mesh, with ``out_size`` the block size.

Judged: every row of each kept result must be ok, with ``total`` equal to
the block's length and the block's bytes, against the blocks the seed made.
The control is the plain reference decoder with copies moved as one block
(``reference.decode_rows(..., overlap=False)``) in the program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import encoder, reference

DIRECTION = "decode"


@dataclass
class State:
    device: torch.device
    rows: int  # rows a batch
    block: int  # bytes a block
    host: np.ndarray  # u8[N, block]: the blocks the seed made
    comp: torch.Tensor  # u8[N, width] on the device
    clens: torch.Tensor  # i32[N] on the device
    ulens: torch.Tensor  # i32[N] on the device
    comp_bytes: list[int]  # compressed bytes of each batch
    mesh: object

    def batch(self, b: int) -> slice:
        return slice(b * self.rows, (b + 1) * self.rows)


def stream_width(block: int) -> int:
    """A stream row's width: the encoder's bound rounded up to 16, with 16
    bytes to spare past any stream."""
    return -(-encoder.max_compressed_length(block) // 16) * 16 + 16


def prepare(blocks: torch.Tensor, config: dict, cell: dict, device: torch.device) -> State:
    from snappy_tpu_torch.parallel import distributed

    rows, block = config["blocks_per_batch"], config["block_size"]
    host = blocks.cpu().numpy()
    comp, clens = encoder.compress_rows(host, np.full(len(host), block, np.int32), stream_width(block))
    per_batch = clens.reshape(-1, rows).sum(axis=1, dtype=np.int64)
    return State(
        device=device, rows=rows, block=block, host=host,
        comp=torch.from_numpy(comp).to(device), clens=torch.from_numpy(clens).to(device),
        ulens=torch.full((len(host),), block, dtype=torch.int32, device=device),
        comp_bytes=[int(x) for x in per_batch], mesh=distributed.mesh_1d([device]),
    )


def batches(state: State) -> int:
    return len(state.host) // state.rows


def call(state: State, b: int):
    """One batch through the program: (out, ok, total)."""
    from snappy_tpu_torch.parallel import distributed

    s = state.batch(b)
    outs, oks, totals = distributed.decompress_blocks(state.comp[s], state.clens[s], state.ulens[s], state.mesh,
                                                      state.block)
    return outs[0], oks[0], totals[0]


def control(state: State, b: int):
    """One batch through the control in the program's place."""
    s = state.batch(b)
    out, ok = reference.decode_rows(state.comp[s], state.clens[s], state.ulens[s], state.block, overlap=False)
    return out, ok, torch.where(ok, state.ulens[s], 0)


def work(state: State, b: int, result) -> dict:
    """What batch ``b`` moved: rows, uncompressed bytes, stream bytes."""
    return {"rows": state.rows, "bytes": state.rows * state.block, "comp_bytes": state.comp_bytes[b]}


def wrong_rows(state: State, b: int, result) -> int:
    """Rows of batch ``b`` that the result gets wrong."""
    out, ok, total = result
    s = state.batch(b)
    raw = torch.from_numpy(state.host[s]).to(state.device)
    if tuple(out.shape) != tuple(raw.shape):
        return state.rows
    bad = ~ok.bool() | (total != state.ulens[s]) | (out != raw).any(dim=1)
    return int(bad.sum())
