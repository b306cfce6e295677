"""Helpers shared by the tests that hold snappy_tpu_torch against snappy_tpu.

They live here and not in the port, because the port must not import
snappy_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import snappy_tpu_torch.core.config as port_config
from snappy_tpu.core import config as ref_config
from snappy_tpu.core.constants import BLOCK_SIZE


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


def native_block_streams(raw: bytes, block_size: int = BLOCK_SIZE) -> tuple[list[bytes], list[int]]:
    """Headerless tag streams of each block of ``raw`` from the port's
    native ``compress_rows``, and the blocks' lengths."""
    from snappy_tpu_torch.native import runtime as nat

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
