"""The sharded codec once through an n-shard mesh.

    python -m snappy_tpu_torch.tools.dryrun_multichip N [--device cuda|cpu]

The counterpart of ``__graft_entry__.py::dryrun_multichip``: on a mesh of
N shards (``cuda``: the visible cards in turn, so one card may hold them
all; ``cpu``: N shards of the plain versions) it runs the framed round
trip through ``compress_framed`` and ``uncompress_framed`` with ``mesh=``,
then ``distributed.compress_blocks`` and ``decompress_blocks`` with
``gather=True``: every device must hold the whole result, equal to the
shards of ``gather=False`` joined, and the decode must give the input
back. The data are N blocks of a few hundred bytes from a seed. Raises on
any mismatch; prints one line when all holds.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.constants import BLOCK_SIZE
from ..ops.decode_torch import COMP_PAD
from ..ops.encode_torch import ENC_PAD
from ..parallel import distributed, host


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def mesh_devices(n_devices: int, device: str) -> list[torch.device]:
    """N shards on ``device``: the visible cards in turn for ``cuda``."""
    if device != "cuda":
        return [torch.device(device)] * n_devices
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("dryrun_multichip: no CUDA device is visible")
    return [torch.device("cuda", i % cards) for i in range(n_devices)]


def _same_everywhere(gathered: list[torch.Tensor], shards: list[torch.Tensor]) -> bool:
    whole = host.join_rows([r for c in distributed.to_host([shards]) for r in c.wait()])
    return all(np.array_equal(g.cpu().numpy(), whole) for g in gathered)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """Run the checks above; returns the line it prints."""
    mesh = distributed.mesh_1d(mesh_devices(n_devices, device))

    # Tiny shapes: n_devices blocks' worth, a few hundred bytes each.
    rng = np.random.default_rng(1)
    words = rng.integers(0, 256, size=(8, 16), dtype=np.uint8)
    raw = words[rng.integers(0, 8, size=(n_devices * 512) // 16)].reshape(-1).tobytes()

    # The framed round trip through the mesh: sharded encode, sharded decode.
    frame = host.compress_framed(raw, mesh=mesh)
    _check(host.uncompress_framed(frame, mesh=mesh) == raw, "sharded round trip mismatch")

    # The ordered gather of the encode: one row a shard.
    nb = distributed.pad_block_count(1, n_devices)
    buf = np.zeros((nb, BLOCK_SIZE + ENC_PAD), np.uint8)
    blens = np.zeros(nb, np.int32)
    inp = np.frombuffer(raw, np.uint8)
    per = -(-len(inp) // nb)
    for i in range(nb):
        c = inp[i * per : (i + 1) * per]
        buf[i, : len(c)] = c
        blens[i] = len(c)
    comp, olens = distributed.compress_blocks(buf, blens, mesh, gather=True)
    shard_comp, shard_olens = distributed.compress_blocks(buf, blens, mesh)
    _check(_same_everywhere(comp, shard_comp) and _same_everywhere(olens, shard_olens),
           "gathered encode differs from its shards")

    # ... and of the decode.
    comp_np, olens_np = comp[0].cpu().numpy(), olens[0].cpu().numpy()
    dcomp = np.zeros((nb, comp_np.shape[1] + COMP_PAD), np.uint8)
    dcomp[:, : comp_np.shape[1]] = comp_np
    out, ok, total = distributed.decompress_blocks(dcomp, olens_np, blens, mesh, BLOCK_SIZE, gather=True)
    shard_out, shard_ok, shard_total = distributed.decompress_blocks(dcomp, olens_np, blens, mesh, BLOCK_SIZE)
    _check(all(bool(o.all()) for o in ok), "gathered decode flagged corrupt")
    _check(_same_everywhere(out, shard_out) and _same_everywhere(ok, shard_ok)
           and _same_everywhere(total, shard_total), "gathered decode differs from its shards")
    out_np = out[0].cpu().numpy()
    _check(b"".join(out_np[i, : blens[i]].tobytes() for i in range(nb)) == raw, "gathered decode mismatch")
    line = (f"dryrun_multichip({n_devices}) on {', '.join(str(d) for d in mesh.devices)}: sharded encode+decode "
            f"+ ordered gather (encode AND decode) OK")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.dryrun_multichip", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
