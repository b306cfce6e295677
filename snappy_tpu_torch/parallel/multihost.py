"""Multi-host framed codec drivers: one frame written and read by several
processes.

The counterpart of ``snappy_tpu/parallel/multihost.py``. Every process
reads only its disjoint byte range of the input, codes its own blocks on
the devices it feeds, and the frame is assembled without passing the
payload through one process:

  compress:   per-process read of its block range, encode on its local
              shards (``distributed.compress_blocks``), then an all_gather
              of the per-block compressed lengths and crcs, the only
              exchange (4-8 bytes a block); every process computes its
              payload offsets from the whole index and pwrites its own
              slice, and process 0 writes the header and index.
  decompress: every process reads the frame's index and only its own
              payload range, decodes its blocks and pwrites its output at
              block_size offsets. No collective but the closing barrier.

The exchange is gloo's: lengths and crcs are host values, the barriers
carry nothing, and no device tensor crosses processes, so NCCL is not
needed. Gloo also lets several processes share one card (NCCL refuses two
ranks on one device), which is how one H100 runs a two-process group.

As in the reference, this path routes no block: every block is encoded
on the devices (``host.py``), and the frame equals the single-process mesh
frame of the same data and config, whatever the number of processes.

Call :func:`initialize` once per process before using these drivers.

**Filesystem requirement:** ``in_path`` and ``out_path`` must live on a
filesystem that every process shares. Each process pwrites only its own
slice, so on per-host local disks every host would hold an incomplete file.
After the barrier every process parses the header and index from disk, and
process 0 decodes a sampled block of each peer's payload slice with the
host oracle, so that misconfiguration fails loudly on every process.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

from ..core import varint
from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..cpu import oracle
from ..ops.host import blockify
from ..ops.select import check_encoder
from . import distributed, framed, host


def initialize(coordinator_address: str, num_processes: int, process_id: int, **kw) -> None:
    """Join the process group over gloo at ``tcp://coordinator_address``
    (``host:port``; rank 0 listens there). ``kw`` goes to
    ``torch.distributed.init_process_group`` (e.g. ``timeout``, a
    ``datetime.timedelta``)."""
    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        **kw,
    )


def local_device() -> torch.device:
    """The card this process feeds by default: ``cuda:{rank % cards}``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("multihost: no CUDA device is visible; name the local devices")
    return torch.device("cuda", dist.get_rank() % n)


def global_mesh(axis: str = distributed.AXIS, *, local_devices=None) -> distributed.Mesh:
    """1-D mesh over every process's devices, in rank order. Each process
    contributes ``local_devices`` (by default :func:`local_device`); every
    process must contribute as many."""
    local = [str(torch.device(d)) for d in (local_devices or [local_device()])]
    everyone: list = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, local)
    if len({len(devs) for devs in everyone}) != 1:
        raise ValueError(f"processes contribute unequal device counts: {[len(d) for d in everyone]}")
    devices = tuple(torch.device(d) for devs in everyone for d in devs)
    ranks = tuple(r for r, devs in enumerate(everyone) for _ in devs)
    return distributed.Mesh(devices, ranks, axis)


def _my_positions(mesh: distributed.Mesh) -> tuple[int, int]:
    """[first, last + 1) of this process's positions in ``mesh``; refuses a
    mesh where they are not contiguous."""
    rank = distributed.process_rank()
    mine = [i for i, r in enumerate(mesh.ranks) if r == rank]
    if not mine:
        raise RuntimeError(f"process {rank} feeds no device of the mesh")
    if mine[-1] - mine[0] + 1 != len(mine):
        # Non-contiguous positions would claim other processes' blocks and
        # desynchronise the file I/O from the sharding.
        raise RuntimeError(
            "multihost drivers require each process's devices to be contiguous in mesh order; "
            f"process {rank} owns mesh positions {mine}"
        )
    return mine[0], mine[-1] + 1


def _my_block_range(nb_padded: int, mesh: distributed.Mesh) -> tuple[int, int]:
    """The contiguous block range this process owns when ``nb_padded``
    blocks shard over ``mesh`` in order."""
    per_dev = nb_padded // mesh.size
    first, end = _my_positions(mesh)
    return first * per_dev, end * per_dev


def _local_mesh(mesh: distributed.Mesh) -> distributed.Mesh:
    first, end = _my_positions(mesh)
    return distributed.Mesh(mesh.devices[first:end], mesh.ranks[first:end], mesh.axis)


def _allgather_rows(local: np.ndarray) -> np.ndarray:
    """Equal-shaped int32 host values of every process, joined in rank
    order (the only exchange; 4-8 bytes a block)."""
    t = torch.from_numpy(np.ascontiguousarray(local, dtype=np.int32))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


def _not_shared(what: str) -> str:
    return f"{what}: are all processes writing to the same (shared) filesystem?"


def compress_framed(
    in_path: str,
    out_path: str,
    mesh: distributed.Mesh | None = None,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
    *,
    encoder: str = "kernel",
) -> int:
    """Multi-host framed compress: every process encodes its disjoint block
    range of ``in_path`` with the block encoder ``encoder`` and pwrites its
    frame slice of ``out_path``. Returns the frame size (the same on every
    process)."""
    check_encoder(encoder)
    mesh = global_mesh() if mesh is None else mesh
    bs = config.block_size
    total_len = os.path.getsize(in_path)
    n_blocks = -(-total_len // bs)
    nb = distributed.pad_block_count(max(n_blocks, 1), mesh.size)
    lo, hi = _my_block_range(nb, mesh)

    # Per-process I/O: read only this process's byte range.
    with open(in_path, "rb") as f:
        f.seek(lo * bs)
        local = np.frombuffer(f.read((hi - lo) * bs), np.uint8)
    buf, blens = blockify(local, bs, hi - lo)
    sharded = distributed.compress_blocks(buf, blens, _local_mesh(mesh), min_profit=config.min_profit,
                                          encoder=encoder)
    n_local = max(0, min(hi, n_blocks) - lo)
    local_crcs = np.zeros(hi - lo, np.uint32)
    local_crcs[:n_local] = framed.crc32s([local[i * bs : i * bs + int(blens[i])] for i in range(n_local)])
    streams = host.mesh_streams(distributed.to_host(sharded), hi - lo)

    # The exchange: per-block compressed lengths (and crcs).
    all_olens = _allgather_rows(np.array([len(s) for s in streams], np.int32))[:n_blocks]
    all_crcs = _allgather_rows(local_crcs.view(np.int32))[:n_blocks].view(np.uint32) if config.checksum else None

    header = framed.build_frame_header(
        all_olens.tolist(), all_crcs.tolist() if all_crcs is not None else None, total_len, config
    )
    offsets = len(header) + np.concatenate([[0], np.cumsum(all_olens, dtype=np.int64)])
    frame_size = int(offsets[-1])

    fd = os.open(out_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, frame_size)
        if dist.get_rank() == 0:
            os.pwrite(fd, header, 0)
        for i, s in enumerate(streams[:n_local]):
            os.pwrite(fd, s, int(offsets[lo + i]))
    finally:
        os.close(fd)
    dist.barrier()
    # Post-write verification, after the barrier so that every process has
    # written. A size check alone cannot catch a filesystem that is not
    # shared (each process ftruncates its own file to frame_size), so:
    # every process parses the header and index from disk (on local disks,
    # process 0's header is not there for the others), and process 0
    # decodes one block of each other process's payload slice.
    if os.path.getsize(out_path) != frame_size:
        raise RuntimeError(_not_shared(f"assembled frame {out_path} is {os.path.getsize(out_path)} bytes, "
                                       f"expected {frame_size}"))
    with open(out_path, "rb") as vf:
        try:
            framed.parse_index(vf.read(len(header)), require_payload=False)
        except CorruptInputError as e:
            raise RuntimeError(_not_shared(f"the header of {out_path} does not parse ({e})")) from e
    if dist.get_rank() == 0 and n_blocks:
        per_dev = nb // mesh.size
        first_block: dict[int, int] = {}
        for pos, r in enumerate(mesh.ranks):
            first_block.setdefault(r, pos * per_dev)
        with open(out_path, "rb") as vf:
            for r, blk in sorted(first_block.items()):
                if r == 0 or blk >= n_blocks:
                    continue
                vf.seek(int(offsets[blk]))
                stream = vf.read(int(all_olens[blk]))
                ulen = min(bs, total_len - blk * bs)
                try:
                    out_blk = oracle.uncompress(varint.encode32(ulen) + stream)
                except CorruptInputError as e:
                    raise RuntimeError(_not_shared(f"the payload slice of process {r} (block {blk}) does not "
                                                   f"decode ({e})")) from e
                if len(out_blk) != ulen or (all_crcs is not None and zlib.crc32(out_blk) != int(all_crcs[blk])):
                    raise RuntimeError(_not_shared(f"the payload slice of process {r} (block {blk}) decodes "
                                                   "to other bytes"))
    return frame_size


def uncompress_framed(in_path: str, out_path: str, mesh: distributed.Mesh | None = None) -> int:
    """Multi-host framed decompress: every process reads only its payload
    range, decodes its blocks and pwrites its output slice. Returns the
    uncompressed length."""
    mesh = global_mesh() if mesh is None else mesh
    with open(in_path, "rb") as f:
        head = f.read(framed._HEADER.size)
        if len(head) < framed._HEADER.size:
            raise CorruptInputError("frame too short")
        _magic, flags, _block_size, _total_len, n_blocks = framed._HEADER.unpack(head)
        index = f.read(4 * n_blocks * (2 if flags & framed.FLAG_CRC else 1))
        idx = framed.parse_index(head + index, require_payload=False)
        if n_blocks == 0:
            if dist.get_rank() == 0:
                open(out_path, "wb").close()
            dist.barrier()
            return 0
        nb = distributed.pad_block_count(n_blocks, mesh.size)
        lo, hi = _my_block_range(nb, mesh)
        n_local = max(0, min(hi, n_blocks) - lo)
        ranges = idx.block_ranges()[lo : lo + n_local]
        # Per-process payload I/O: only its blocks' contiguous bytes.
        base = ranges[0][0] if n_local else 0
        size = ranges[-1][1] - base if n_local else 0
        f.seek(base)
        payload = f.read(size)
        if len(payload) < size:
            raise CorruptInputError("frame payload truncated")

    clens = np.array([e - s for s, e in ranges], np.int64)
    ulens = np.array([idx.block_ulen(lo + i) for i in range(n_local)], np.int64)
    bs = int(idx.block_size)
    local_mesh = _local_mesh(mesh)
    # The payload's blocks lie end to end.
    batch = host.block_batch(np.frombuffer(payload, np.uint8), clens, ulens, bs, hi - lo, local_mesh.devices[0])
    copies = distributed.to_host(distributed.decompress_blocks(*batch, local_mesh, bs))
    outs, oks, _ = zip(*(c.wait() for c in copies))
    ok = host.join_rows(oks)[:n_local]
    if not ok.all():
        raise CorruptInputError(f"corrupt framed block {lo + int(np.flatnonzero(~ok)[0])}")
    out = host.join_rows(outs)
    blocks = [out[i, : ulens[i]] for i in range(n_local)]
    framed.verify_crcs_range(idx, blocks, lo)

    fd = os.open(out_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, int(idx.total_len))
        for i, b in enumerate(blocks):
            os.pwrite(fd, b, (lo + i) * bs)
    finally:
        os.close(fd)
    dist.barrier()
    return int(idx.total_len)
