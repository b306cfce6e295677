"""The port's public calls take the reference's arguments, on the CPU.

Every public function of ``snappy_tpu`` and of its ``parallel`` modules
has a counterpart of the same name in ``snappy_tpu_torch`` whose
positional parameters are the reference's: the same names, in the same
order, with the same defaults. The port's own parameters (``device``,
``encoder``, ``local_devices``) are keyword-only, so a call site written
for the reference means the same in the port. Then the calls themselves:
the reference's positional and keyword forms give the reference's bytes.

Last, the port stands alone: a copy of ``snappy_tpu_torch/`` with nothing
of the repository beside it builds its native codec from its own source
and writes the frames the in-repo port writes, without importing jax or
``snappy_tpu``.

Tolerance: exact, since the outputs are bytes and signatures.
"""

import dataclasses
import importlib
import inspect
import io
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import pytest
import torch.distributed as dist

import snappy_tpu
import snappy_tpu_torch
from snappy_tpu.core.config import FrameConfig as RefFrameConfig
from snappy_tpu.parallel import streaming as ref_streaming
from snappy_tpu_torch.parallel import distributed, multihost, streaming

from conftest import TESTDATA, read_testdata
from torch_helpers import config_from_reference, reference_mesh_k2_patched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["", ".parallel", ".parallel.streaming", ".parallel.multihost", ".parallel.host",
           ".parallel.framed", ".parallel.distributed"]
PORT_ONLY = {"device", "encoder", "local_devices"}


def public_functions(mod) -> list[str]:
    """The functions ``mod`` exports: its ``__all__``, or else those it
    defines without a leading underscore."""
    if hasattr(mod, "__all__"):
        return [n for n in mod.__all__ if inspect.isfunction(getattr(mod, n))]
    return sorted(n for n, v in vars(mod).items()
                  if inspect.isfunction(v) and v.__module__ == mod.__name__ and not n.startswith("_"))


FUNCTIONS = [(m, n) for m in MODULES for n in public_functions(importlib.import_module("snappy_tpu" + m))]


def same_default(ref, port) -> bool:
    """A default of the reference's equals the port's; a config is a
    dataclass of the same name and fields in each package."""
    if dataclasses.is_dataclass(ref):
        return type(ref).__name__ == type(port).__name__ and dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref is port or ref == port


@pytest.mark.parametrize("module,name", FUNCTIONS, ids=[f"snappy_tpu{m}.{n}" for m, n in FUNCTIONS])
def test_signature_takes_the_references_arguments(module, name):
    ref = inspect.signature(getattr(importlib.import_module("snappy_tpu" + module), name))
    port = inspect.signature(getattr(importlib.import_module("snappy_tpu_torch" + module), name))
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    ref_pos = [p for p in ref.parameters.values() if p.kind in positional]
    port_pos = [p for p in port.parameters.values() if p.kind in positional]
    assert [(p.name, p.kind) for p in port_pos] == [(p.name, p.kind) for p in ref_pos]
    for r, p in zip(ref_pos, port_pos):
        assert same_default(r.default, p.default), (r.name, r.default, p.default)
    rest = {p.name: p.kind for p in port.parameters.values() if p.kind not in positional}
    ref_rest = {p.name: p.kind for p in ref.parameters.values() if p.kind not in positional}
    # What the reference takes beyond its positional parameters, the port
    # takes too; whatever else the port takes is its own, by keyword only.
    assert ref_rest.items() <= rest.items()
    for extra in rest.keys() - ref_rest.keys():
        assert rest[extra] == inspect.Parameter.KEYWORD_ONLY and extra in PORT_ONLY, extra


# --- the reference's call sites, in the port ------------------------------

HTML = read_testdata("html")  # 102,400 bytes
MESH_RAW, MESH_BLOCK = HTML[:30000], 4096


@pytest.fixture(scope="module")
def html_frame():
    return snappy_tpu_torch.compress_framed(HTML, device="cpu")


def test_uncompress_framed_mesh_none_by_position(html_frame):
    assert snappy_tpu.uncompress_framed(html_frame, None) == HTML
    assert snappy_tpu_torch.uncompress_framed(html_frame, None, device="cpu") == HTML
    assert snappy_tpu_torch.parallel.host.dispatch_uncompress(html_frame, None, device="cpu")[0].n_blocks == 2


@pytest.fixture(scope="module")
def ref_mesh_frame():
    """The reference's frame of MESH_RAW over a mesh of two of conftest's
    virtual CPU devices, K2 on each shard."""
    with reference_mesh_k2_patched():
        return snappy_tpu.compress_framed(MESH_RAW, RefFrameConfig(block_size=MESH_BLOCK),
                                          snappy_tpu.mesh_1d(jax.devices()[:2]))


def test_compress_framed_mesh_by_position(ref_mesh_frame):
    mesh = snappy_tpu_torch.mesh_1d(["cpu"] * 2)
    cfg = config_from_reference(RefFrameConfig(block_size=MESH_BLOCK))
    assert snappy_tpu_torch.compress_framed(MESH_RAW, cfg, mesh, device="cpu") == ref_mesh_frame
    assert snappy_tpu_torch.parallel.host.compress_framed(MESH_RAW, cfg, mesh) == ref_mesh_frame


def test_uncompress_framed_mesh_by_position(ref_mesh_frame):
    ref_mesh = snappy_tpu.mesh_1d(jax.devices()[:2])
    mesh = snappy_tpu_torch.mesh_1d(["cpu"] * 2)
    want = snappy_tpu.uncompress_framed(ref_mesh_frame, ref_mesh)
    assert want == MESH_RAW
    assert snappy_tpu_torch.uncompress_framed(ref_mesh_frame, mesh, device="cpu") == want


def test_streams_by_position(tmp_path):
    """compress_stream(src, dst, config, mesh, blocks_per_frame) and
    uncompress_stream(src, dst, mesh, max_retries), positionally."""
    cfg = RefFrameConfig(block_size=4096)
    port_seq = io.BytesIO()
    streaming.compress_stream(io.BytesIO(HTML), port_seq, config_from_reference(cfg), None, 8, device="cpu")
    outs = {}
    for name, pkg, kw in (("ref", ref_streaming, {}), ("port", streaming, {"device": "cpu"})):
        out = io.BytesIO()
        assert pkg.uncompress_stream(io.BytesIO(port_seq.getvalue()), out, None, 2, **kw) == len(HTML)
        outs[name] = out.getvalue()
    assert outs["port"] == outs["ref"] == HTML
    assert len(list(streaming.iter_frames(io.BytesIO(port_seq.getvalue())))) == 4  # 25 blocks, 8 a frame
    src, out = tmp_path / "in.bin", tmp_path / "out.snpf"
    src.write_bytes(HTML)
    assert streaming.resume_compress_file(str(src), str(out), config_from_reference(cfg), None, 8,
                                          device="cpu") == len(port_seq.getvalue())
    assert out.read_bytes() == port_seq.getvalue()


def test_uncompressed_length_by_keyword():
    comp = snappy_tpu_torch.compress(HTML)
    assert snappy_tpu_torch.uncompressed_length(comp=comp) == snappy_tpu.uncompressed_length(comp=comp)
    assert snappy_tpu_torch.uncompressed_length(comp=comp)[0] == len(HTML)


def test_resume_uncompress_file_takes_the_references_keywords(tmp_path):
    """The reference's resume takes ``**kw`` and retries nothing; the port's
    takes the same keywords."""
    raw = read_testdata("html_x_4")  # 409,600 bytes
    src, comp = tmp_path / "in.bin", tmp_path / "c.snpf"
    src.write_bytes(raw)
    streaming.compress_file(str(src), str(comp), device="cpu")
    sizes = {}
    for name, pkg, kw in (("ref", ref_streaming, {}), ("port", streaming, {"device": "cpu"})):
        out = tmp_path / f"{name}.out"
        out.write_bytes(raw[:70000])
        sizes[name] = pkg.resume_uncompress_file(str(comp), str(out), max_retries=2, **kw)
        assert out.read_bytes() == raw
    assert sizes["port"] == sizes["ref"] == len(raw)


def test_global_mesh_axis_by_position():
    """``global_mesh(axis)`` as in the reference; the devices this process
    feeds by keyword. One process, one rank."""
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = multihost.global_mesh("shards", local_devices=["cpu"] * 2)
        assert (mesh.axis, mesh.size, mesh.ranks) == ("shards", 2, (0, 0))
        assert multihost.global_mesh(local_devices=["cpu"]).axis == distributed.AXIS
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --- the port alone -------------------------------------------------------

STANDALONE = """
import importlib.util, json, sys
assert importlib.util.find_spec("snappy_tpu") is None, "snappy_tpu is importable"
import snappy_tpu_torch as st
from snappy_tpu_torch.native import build, runtime
raw = open("html", "rb").read()
available = runtime.available()
assert st.uncompress(st.compress(raw)) == raw
assert st.uncompress(st.compress(raw, backend="torch", device="cpu"), backend="torch", device="cpu") == raw
frame = st.compress_framed(raw, device="cpu")
assert st.uncompress_framed(frame, device="cpu") == raw
open("html.snpf", "wb").write(frame)
print(json.dumps({"available": available, "lib": str(build.build()),
                  "imported": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "snappy_tpu"))}))
"""


def test_the_port_builds_and_runs_alone(tmp_path, html_frame):
    shutil.copytree(os.path.join(REPO, "snappy_tpu_torch"), tmp_path / "snappy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(TESTDATA, "html"), tmp_path / "html")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    run = subprocess.run([sys.executable, "-c", STANDALONE], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["available"], "the native codec did not build from the port's own source"
    assert got["lib"].startswith(str(tmp_path / "snappy_tpu_torch" / "_build"))
    assert got["imported"] == []
    assert (tmp_path / "html.snpf").read_bytes() == html_frame
