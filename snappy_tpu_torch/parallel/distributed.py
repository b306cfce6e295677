"""Block-parallel codec over a 1-D mesh of devices.

The counterpart of ``snappy_tpu/parallel/distributed.py``. There a batch
of blocks is sharded over a ``jax.sharding.Mesh`` and ``shard_map`` runs the
block codec on each device's rows. Here a :class:`Mesh` is an ordered tuple
of ``torch.device``, and the same split is plain launches in mesh order:
the batch is cut into ``mesh.size`` equal contiguous shards, each shard is
copied to its device (pinned, ``non_blocking``; a decode batch built on a
device goes from there) and the block encoder (K2) or decoder (K1) is
launched on it, every shard queued before any result is read; ``to_host``
brings each shard's results back behind an event of its own. Nothing is
compiled, so nothing is cached.

A device may appear more than once: its shards then queue one after the
other on its current stream. That is how one card runs a mesh of several
shards. The ordered ``all_gather`` of ``gather=True`` is, within one
process, device-to-device copies into the whole result on every device.

Across processes see ``multihost.py``: each process runs its own shards
with these functions on the devices it feeds.

``decompress_streams`` is the batched raw-stream decoder beside
``decompress_blocks``: many raw Snappy streams at any offsets of one buffer
on one device, each decoded into its place in one output, as a columnar
reader decodes every page of a row group. ``compress_streams`` is its
encoder: many pages at any offsets of one buffer, each written as a raw
stream, the streams end to end in one output, as a columnar writer
compresses every page of a row group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import DEFAULT_MIN_PROFIT
from ..ops import cuda_decode, cuda_encode, cuda_join, cuda_segment, select
from ..ops.host import HostCopy, stage
from ..utils.profiling import trace_annotation

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
    *,
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
        out, olen = encode(*stage([blocks[lo:hi], blens[lo:hi]], dev), mp)
        outs.append(out)
        olens.append(olen)
    if gather:
        return _gather(outs, mesh), _gather(olens, mesh)
    return outs, olens


def decompress_blocks(comp, clens, ulens, mesh: Mesh, out_size: int, gather: bool = False):
    """Decode a uint8[NB, C] batch of headerless block streams sharded over
    ``mesh``: host arrays, or tensors (``host.frame_batch``) that each
    shard's device takes from where they lie. Returns (outs, oks, totals)
    per device in mesh order, as compress_blocks does. Runs in the span
    ``blocks.decompress``."""
    with trace_annotation("blocks.decompress"):
        if isinstance(comp, torch.Tensor):
            def shard(dev, lo, hi):
                return [t[lo:hi].to(dev, non_blocking=True) for t in (comp, clens, ulens)]
        else:
            args = (comp, np.asarray(clens, dtype=np.int32), np.asarray(ulens, dtype=np.int32))

            def shard(dev, lo, hi):
                return stage([a[lo:hi] for a in args], dev)
        outs, oks, totals = [], [], []
        for dev, (lo, hi) in zip(mesh.devices, _shards(mesh, len(comp))):
            out, ok, total = select.block_decoder(dev)(*shard(dev, lo, hi), out_size)
            outs.append(out)
            oks.append(ok)
            totals.append(total)
        if gather:
            return _gather(outs, mesh), _gather(oks, mesh), _gather(totals, mesh)
        return outs, oks, totals


def decompress_streams(comp: torch.Tensor, starts: torch.Tensor, clens: torch.Tensor, ulens: torch.Tensor,
                       out_starts: torch.Tensor, out_len: int):
    """Decode n raw Snappy streams that lie in one buffer, each into its
    place in one output, in one call on the buffer's device.

    ``comp`` is uint8[N]; stream i is the ``clens[i]`` bytes at
    ``starts[i]`` (int64, int32; any offset), its varint header included,
    and is stated to decode to ``ulens[i]`` bytes (int32), which go to
    ``out_starts[i]`` (int64) of an output of ``out_len`` bytes. Returns
    (out uint8[out_len], ok bool[n]) on the same device; stream i is ok
    where its header equals ``ulens[i]``, it and its output lie in their
    buffers, and it decodes to exactly that many bytes. A stream that is
    not ok touches no other stream's output; its own bytes are not
    specified, nor are the bytes of ``out`` that no stream covers.

    The headers are checked and each stream is cut into segments on the
    device by K4 (``ops/cuda_segment.py``), and all segments of all streams
    are decoded by one launch of K1's ragged variant
    (``ops/cuda_decode.py::decode_segments``). On a card nothing waits: the
    launches are queued on the current stream, and only K4's counts follow
    them to the host, for the counters. On the CPU the plain versions run.
    Runs in the span ``streams.decompress``."""
    with trace_annotation("streams.decompress"):
        rows, ok, stats = cuda_segment.segment_streams(comp, starts, clens, ulens, out_starts, out_len)
        out = torch.empty(out_len, dtype=torch.uint8, device=comp.device)
        cuda_decode.decode_segments(comp, rows, stats[:1], out, ok)
        return out, ok.view(torch.bool)


def compress_streams(data: torch.Tensor, starts: torch.Tensor, ulens: torch.Tensor):
    """Compress n pages that lie in one buffer into raw Snappy streams that
    lie end to end in one output, in one call on the buffer's device.

    ``data`` is uint8[N]; page i is the ``ulens[i]`` bytes (int32) at
    ``starts[i]`` (int64; any offset). Returns (comp uint8[cap], cstarts
    int64[n], clens int32[n]) on the same device, with ``cap`` =
    ``cuda_join.stream_bound(n, N)``: stream i is ``comp[cstarts[i] :
    cstarts[i] + clens[i]]``, the streams in page order with nothing between
    them. Stream i is the varint of ``ulens[i]``, then K2's headerless
    stream of each 64 KiB fragment of the page in turn, at
    ``DEFAULT_MIN_PROFIT``: what ``ops/host.py::compress`` writes for the
    page where it routes no block to the host. Nothing is routed here.

    A page whose bytes do not lie in ``data``, or whose length is negative,
    is refused: on the CPU the call raises ValueError; on a card its
    ``clens`` is -1, it takes no bytes of ``comp``, and no other page moves
    or is touched. So is a page whose fragments would pass the call's
    fragment table, which only pages that overlap can reach (the CPU raises
    there too). The bytes of ``comp`` past the last stream are not
    specified.

    Each page is cut into fragments on the device (``cuda_join.
    fragment_table``); K2 encodes them in place in ``data``, the fragments
    over 32 KiB in one launch of its 64 KiB variant and the others in one of
    its 32 KiB variant (``cuda_encode.encode_fragments``; each launch sized
    by a bound the host knows, rows past the real fragments empty), and K5
    writes each page's header and joins its fragments' streams behind it
    (``cuda_join.join_streams``). On a card nothing waits: the launches are
    queued on the current stream. On the CPU the plain versions run. Runs in
    the span ``streams.compress``; counts the pages under
    ``streams.enc_streams`` and the fragments under
    ``streams.enc_fragments`` (``cuda_join.count_call``)."""
    with trace_annotation("streams.compress"):
        n = cuda_encode.check_ranges(data, starts, ulens, ("starts", "ulens"))
        table = cuda_join.fragment_table(starts, ulens, data.numel())
        if data.device.type == "cpu" and bool((table.fcount < 0).any()):
            raise ValueError("a page does not lie in data, has a negative length, or overlaps others past the bound")
        wide, narrow = table.wide, table.narrow
        rows = len(wide[0]) + len(narrow[0])
        frags = torch.empty((rows, cuda_encode.BLOCK_MAX_OUT), dtype=torch.uint8, device=data.device)
        olens = torch.empty(rows, dtype=torch.int32, device=data.device)
        for (fstarts, flens), lo, hi, max_block in ((wide, 0, len(wide[0]), cuda_encode.MAX_BLOCK),
                                                    (narrow, len(wide[0]), rows, cuda_join.NARROW)):
            cuda_encode.encode_fragments(data, fstarts, flens, DEFAULT_MIN_PROFIT, max_block, frags[lo:hi],
                                         olens[lo:hi])
        cap = cuda_join.stream_bound(n, data.numel())
        comp, cstarts, clens = cuda_join.join_streams(frags, olens, table.frow, table.ffirst, table.fcount, ulens,
                                                      cap)
        cuda_join.count_call(n, table.total)
        return comp, cstarts, clens


def to_host(sharded) -> list[HostCopy]:
    """The per-shard results of ``compress_blocks`` or ``decompress_blocks``
    (``gather=False``) on their way to the host: one ``HostCopy`` a shard,
    each behind an event of its own."""
    return [HostCopy(results) for results in zip(*sharded)]


def initialize_multihost(**kwargs) -> None:
    """Join the process group: ``torch.distributed.init_process_group``
    with ``backend="gloo"`` unless another is named. Call once per process
    before building the mesh (``multihost.global_mesh``)."""
    kwargs.setdefault("backend", "gloo")
    dist.init_process_group(**kwargs)
