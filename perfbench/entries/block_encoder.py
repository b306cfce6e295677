"""Encode cells: the program's block encoder with its rows resident.

Set-up puts the configuration's blocks on the device as the encoder takes
them, rows ``ENC_PAD`` bytes wider than a block and zero past it. A call
encodes one resident batch with the program's default block encoder,
``snappy_tpu_torch.ops.select.block_encoder(device)``, at the program's
default ``min_profit`` (``snappy_tpu_torch.core.config.DEFAULT_MIN_PROFIT``):
what ``compress_blocks`` and the framed path call once the rows are on the
device.

Judged: each row's stream, decoded by the plain reference decoder, must be
valid, decode to the row's block, and be no longer than the format's bound.
The control is the frozen encoder with its candidate check removed
(``encoder.compress_rows(..., control=True)``) in the program's place.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import encoder, reference

DIRECTION = "encode"


@dataclass
class State:
    device: torch.device
    rows: int
    block: int
    blocks: torch.Tensor  # u8[N, block + pad] on the device
    blens: torch.Tensor  # i32[N] on the device
    min_profit: int
    encode: object

    def batch(self, b: int) -> slice:
        return slice(b * self.rows, (b + 1) * self.rows)


def prepare(blocks: torch.Tensor, config: dict, cell: dict, device: torch.device) -> State:
    from snappy_tpu_torch.core.config import DEFAULT_MIN_PROFIT
    from snappy_tpu_torch.ops import cuda_encode, select

    rows, block = config["blocks_per_batch"], config["block_size"]
    padded = torch.zeros((len(blocks), block + cuda_encode.ENC_PAD), dtype=torch.uint8, device=device)
    padded[:, :block] = blocks.to(device)
    return State(
        device=device, rows=rows, block=block, blocks=padded,
        blens=torch.full((len(blocks),), block, dtype=torch.int32, device=device),
        min_profit=DEFAULT_MIN_PROFIT, encode=select.block_encoder(device),
    )


def batches(state: State) -> int:
    return len(state.blocks) // state.rows


def call(state: State, b: int):
    """One batch through the program: (out, olens)."""
    s = state.batch(b)
    return state.encode(state.blocks[s], state.blens[s], state.min_profit)


def control(state: State, b: int):
    """One batch through the control in the program's place."""
    s = state.batch(b)
    host = state.blocks[s].cpu().numpy()
    width = -(-encoder.max_compressed_length(state.block) // 16) * 16
    out, olens = encoder.compress_rows(host, np.full(state.rows, state.block, np.int32), width, control=True)
    return torch.from_numpy(out).to(state.device), torch.from_numpy(olens).to(state.device)


def work(state: State, b: int, result) -> dict:
    """What batch ``b`` moved; its stream bytes are the result's lengths,
    summed once the window has closed."""
    return {"rows": state.rows, "bytes": state.rows * state.block, "comp_bytes": result[1]}


def wrong_rows(state: State, b: int, result) -> int:
    """Rows of batch ``b`` whose stream is refused, too long, or decodes to
    other bytes than the row's block."""
    out, olens = result
    s = state.batch(b)
    olens = olens.to(torch.long)
    bound = encoder.max_compressed_length(state.block)
    sane = (olens >= 0) & (olens <= min(bound, out.shape[1]))
    dec, ok = reference.decode_rows(out, torch.where(sane, olens, 0), state.blens[s], state.block)
    bad = ~sane | ~ok | (dec != state.blocks[s, : state.block]).any(dim=1)
    return int(bad.sum())
