"""Block-parallel codec over a 1-D mesh of devices.

The counterpart of ``snappy_tpu/parallel/distributed.py``. There a batch
of blocks is sharded over a ``jax.sharding.Mesh`` and ``shard_map`` runs the
block codec on each device's rows. Here a :class:`Mesh` is an ordered tuple
of ``torch.device``, and the same split is plain launches in mesh order:
the batch is cut into ``mesh.size`` equal contiguous shards, each shard is
copied to its device (pinned, ``non_blocking``) and the block encoder (K2)
or decoder (K1) is launched on it, every shard queued before any result is
read. Nothing is compiled, so nothing is cached.

A device may appear more than once: its shards then queue one after the
other on its current stream. That is how one card runs a mesh of several
shards. The ordered ``all_gather`` of ``gather=True`` is, within one
process, device-to-device copies into the whole result on every device.

Across processes see ``multihost.py``: each process runs its own shards
with these functions on the devices it feeds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import DEFAULT_MIN_PROFIT
from ..ops import select
from ..ops.host import to_device

AXIS = "blocks"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices that hold the shards in order, and the
    process rank that feeds each of them."""

    devices: tuple[torch.device, ...]
    ranks: tuple[int, ...]
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def process_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def mesh_1d(devices=None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the block (data-parallel) axis, fed by this process.

    Without ``devices`` it takes every CUDA device the process sees,
    ``cuda:0`` to ``cuda:n-1``, and raises where there is none. A device may
    be named more than once (several shards on one card); ``["cpu"] * 4``
    runs the plain versions of the kernels."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("mesh_1d: no CUDA device is visible; name the mesh's devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"no block codec for device {d}")
    return Mesh(devs, (process_rank(),) * len(devs), axis)


def pad_block_count(n_blocks: int, n_devices: int) -> int:
    """Blocks are padded to a multiple of the mesh size; empty blocks
    (blen == 0, or clen == ulen == 0) encode and decode to nothing."""
    return -(-n_blocks // n_devices) * n_devices


def _shards(mesh: Mesh, n_rows: int) -> list[tuple[int, int]]:
    """The [lo, hi) rows of each device of ``mesh``, in mesh order."""
    if any(r != process_rank() for r in mesh.ranks):
        raise ValueError("the mesh holds devices of other processes; launch on the local part of it")
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} devices (see pad_block_count)")
    per = n_rows // mesh.size
    return [(i * per, (i + 1) * per) for i in range(mesh.size)]


def _gather(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The shards ``parts`` joined in mesh order on every device of
    ``mesh``; a device named more than once gets one copy."""
    whole: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in whole:
            whole[dev] = torch.cat([p.to(dev, non_blocking=True) for p in parts])
    return [whole[dev] for dev in mesh.devices]


def compress_blocks(
    blocks: np.ndarray,
    blens: np.ndarray,
    mesh: Mesh,
    gather: bool = False,
    min_profit: int | None = None,
    encoder: str = "kernel",
):
    """Encode a uint8[NB, block_size + ENC_PAD] batch sharded over ``mesh``
    with the block encoder ``encoder`` (``select.ENCODERS``).

    NB must be a multiple of the mesh size (see pad_block_count). Returns
    (outs, olens), one entry a device in mesh order: its shard's
    (out u8[NB / size, BLOCK_MAX_OUT], olens i32[NB / size]), or with
    ``gather=True`` the whole [NB, ...] result on that device. The launches
    are queued and not waited for."""
    blocks = np.ascontiguousarray(blocks)
    blens = np.ascontiguousarray(blens, dtype=np.int32)
    mp = DEFAULT_MIN_PROFIT if min_profit is None else min_profit
    outs, olens = [], []
    for dev, (lo, hi) in zip(mesh.devices, _shards(mesh, len(blocks))):
        encode = select.block_encoder(dev, encoder)
        out, olen = encode(to_device(blocks[lo:hi], dev), to_device(blens[lo:hi], dev), mp)
        outs.append(out)
        olens.append(olen)
    if gather:
        return _gather(outs, mesh), _gather(olens, mesh)
    return outs, olens


def decompress_blocks(
    comp: np.ndarray, clens: np.ndarray, ulens: np.ndarray, mesh: Mesh, out_size: int, gather: bool = False
):
    """Decode a uint8[NB, C] batch of headerless block streams sharded over
    ``mesh``. Returns (outs, oks, totals) per device in mesh order, as
    compress_blocks does."""
    comp = np.ascontiguousarray(comp)
    clens = np.ascontiguousarray(clens, dtype=np.int32)
    ulens = np.ascontiguousarray(ulens, dtype=np.int32)
    outs, oks, totals = [], [], []
    for dev, (lo, hi) in zip(mesh.devices, _shards(mesh, len(comp))):
        out, ok, total = select.block_decoder(dev)(
            to_device(comp[lo:hi], dev), to_device(clens[lo:hi], dev), to_device(ulens[lo:hi], dev), out_size
        )
        outs.append(out)
        oks.append(ok)
        totals.append(total)
    if gather:
        return _gather(outs, mesh), _gather(oks, mesh), _gather(totals, mesh)
    return outs, oks, totals


def initialize_multihost(**kwargs) -> None:
    """Join the process group: ``torch.distributed.init_process_group``
    with ``backend="gloo"`` unless another is named. Call once per process
    before building the mesh (``multihost.global_mesh``)."""
    kwargs.setdefault("backend", "gloo")
    dist.init_process_group(**kwargs)
