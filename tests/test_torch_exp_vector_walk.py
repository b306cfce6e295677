"""The plain versions of the probe kernels P1-P6 against the reference's own
Pallas kernels of ``benchmarks/exp_vector_walk.py`` in interpret mode.

The script is loaded by path and its ``pallas_call`` is given
``interpret=True``; its build functions (``build_chain``, ``build_walk8``,
``build_walk_scalar``, ``build_drain``) run as they are, and the
``pallas_call`` of P5 and P6, which the script builds inside its timing
functions, is built here with the script's specs. The script sets JAX's
compilation cache directory when it is imported; the loader restores it.

Tolerance: exact, whole arrays. Positions of an output that no store reaches
hold ``INT_MIN`` in both. P3 runs on 8 full blocks of the reference's data;
P2 on one group with ``max_advance=7``, since on the reference's data a walk
stalls and the reference kernel never ends. The reference behaviours the
port keeps (the stall, the two modes of P1 and of P4 that compute different
functions) are pinned at the end.
"""

import dataclasses
import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from snappy_tpu_torch.ops import cuda_probes, kernels
from snappy_tpu_torch.ops import probes_torch as pt
from snappy_tpu_torch.tools import exp_vector_walk as tool
from snappy_tpu_torch.tools.exp_vector_walk import drain_inputs, when_inputs
from snappy_tpu_torch.utils import profiling

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "exp_vector_walk.py")


def probe_launches(moved) -> dict:
    """The probe kernels' launch counters that moved (``profiling.since``)."""
    return {k: n for k, n in moved.items() if k.startswith("probe.") and n}


class _Interpreted:
    """``pallas`` with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def ref():
    keep = {k: jax.config.values[k] for k in ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("exp_vector_walk_reference", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in keep.items():
            jax.config.update(k, v)
        sys.path[:] = path
    mod.pl = _Interpreted()
    return mod


def _knob(v):
    return jnp.array([v], jnp.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _chain_kernel(ref, mode, g):
    if mode in ("axis0", "axis1"):
        k = functools.partial(ref._chain_kernel, axis=0 if mode == "axis0" else 1)
    elif mode == "alu":
        k = ref._alu_chain_kernel
    else:
        k = functools.partial(ref._multi_chain_kernel, G=g, mode=mode)
    return ref.build_chain(k, g)


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_cmds_default_is_the_reference(ref, seed):
    cmds, tags = pt.synth_cmds(3, seed)
    r_cmds, r_tags = ref.synth_cmds(3, seed)
    np.testing.assert_array_equal(cmds, r_cmds)
    np.testing.assert_array_equal(tags, r_tags)
    assert cmds.dtype == np.int32 and cmds.shape == (3, pt.NCP)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("mode", pt.CHAIN_MODES)
def test_chain(ref, mode, g):
    x = tool.chain_inputs(g, seed=11)
    for reps in (0, 37):
        want = _chain_kernel(ref, mode, g)(_knob(reps), jnp.asarray(x))
        _eq(pt.chain(reps, _t(x), mode), want)


@pytest.mark.parametrize("nrow", [pt.R_ROWS, 77])
def test_walk8(ref, nrow):
    cmds, _ = pt.synth_cmds(8, seed=4, max_advance=7)
    cmds_g = cmds.reshape(1, 8, pt.R_ROWS, pt.LANES).transpose(0, 2, 1, 3).copy()
    clen = np.full((1, 8, pt.LANES), pt.NCP, np.int32)
    clen[0, 3] = 20_000  # one walk ends early
    rec, meta = ref.build_walk8(1)(_knob(nrow), jnp.asarray(clen), jnp.asarray(cmds_g))
    p_rec, p_meta = pt.walk8(nrow, _t(clen), _t(cmds_g))
    _eq(p_meta, meta)
    _eq(p_rec, rec)
    assert int(p_meta[0, 0, 1]) > 0 and bool((p_rec[0, 0] != pt.INT_MIN).any())


@pytest.mark.parametrize("knob, max_advance", [(0, 8), (1, 8), (2, 7)])
def test_walk_scalar(ref, knob, max_advance):
    """At knob 2 the walks of stall-free data reach the end of the block;
    one block's length lies past it, so its walk reads the last word."""
    cmds, _ = pt.synth_cmds(8, max_advance=max_advance)
    clen = np.full((8, 1, 1), pt.NCP, np.int32)
    clen[2], clen[5] = 9_000, pt.NCP + 300
    meta = ref.build_walk_scalar(8)(_knob(knob), jnp.asarray(clen), jnp.asarray(cmds.reshape(8, 1, pt.NCP)))
    _eq(pt.walk_scalar(knob, _t(clen), _t(cmds.reshape(8, 1, pt.NCP))), meta)


def _drain_kernel(ref, mode):
    if mode == "serial":
        return ref.build_drain(ref._drain_serial_kernel)
    return ref.build_drain(functools.partial(ref._drain8_kernel, mode=mode))


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
@pytest.mark.parametrize("knob", [0, 68, 1024])
def test_drain(ref, mode, knob):
    q0, r, fld, src = drain_inputs()
    want = _drain_kernel(ref, mode)(_knob(knob), *(jnp.asarray(a) for a in (q0, r, fld, src)))
    _eq(pt.drain(knob, _t(q0), _t(r), _t(fld), _t(src), mode), want)


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
def test_drain_per_lane_fields(ref, mode):
    """Fields that differ from lane to lane: the log-roll's stages then
    each read their own lane's shift bits."""
    q0, r, _, src = drain_inputs(seed=2)
    fld = np.random.default_rng(9).integers(0, 1 << 28, (pt.NREC // 8, 8, pt.LANES)).astype(np.int32)
    r[1::4] = r[::4]  # records of a group store to the same row
    want = _drain_kernel(ref, mode)(_knob(256), *(jnp.asarray(a) for a in (q0, r, fld, src)))
    _eq(pt.drain(256, _t(q0), _t(r), _t(fld), _t(src), mode), want)


def _scalar_call(ref, work, unroll, cond, chain):
    k = functools.partial(ref._scalar_loop_kernel, work=work, unroll=unroll, cond=cond, chain=chain)
    return jax.jit(
        pl.pallas_call(
            k,
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
            out_shape=jax.ShapeDtypeStruct((1,), jnp.int32),
            interpret=True,
        )
    )


@pytest.mark.parametrize("variant", pt.SCALAR_VARIANTS, ids=[v[0] for v in pt.SCALAR_VARIANTS])
def test_scalar_loop(ref, variant):
    _, work, unroll, cond, chain = variant
    f = _scalar_call(ref, work, unroll, cond, chain)
    for x in (np.arange(1024) % 7, np.random.default_rng(6).integers(-(1 << 31), 1 << 31, 1024)):
        x = x.astype(np.int32)
        for n in (0, 37, 300):
            _eq(pt.scalar_loop(n, _t(x), work, unroll, cond, chain), f(_knob(n), jnp.asarray(x)))


def _when_call(ref, mode):
    return jax.jit(
        pl.pallas_call(
            functools.partial(ref._when_drain_kernel, mode=mode),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 3 + [pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((pt.WHEN_OUT_ROWS, pt.LANES), jnp.int32),
            interpret=True,
        )
    )


@pytest.mark.parametrize("mode", pt.WHEN_MODES)
@pytest.mark.parametrize("knob", [0, 100, pt.WHEN_RECORDS + 64])
def test_when_drain(ref, mode, knob):
    q, r, src = when_inputs()
    want = _when_call(ref, mode)(_knob(knob), jnp.asarray(q), jnp.asarray(r), jnp.asarray(src))
    _eq(pt.when_drain(knob, _t(q), _t(r), _t(src), mode), want)


# ---------------------------------------------------------------- pins


def test_stall_caps_the_scalar_walk():
    """The reference's data stores a copy of advance 8 as cx = 8, read as
    8 & 7 = 0: every walk of seed 0 stalls and runs to its step cap, 8208,
    though the blocks hold 8,149-8,261 tags."""
    cmds, tags = pt.synth_cmds(8)
    meta = pt.walk_scalar(1, _t(np.full((8, 1, 1), pt.NCP, np.int32)), _t(cmds.reshape(8, 1, pt.NCP)))
    assert meta[:, 0, 1].tolist() == [8208] * 8
    assert int(meta[0, 0, 0]) == 754787
    assert tags.min() == 8149 and tags.max() == 8261


def test_walk8_ends_on_stalled_data(monkeypatch):
    """On the reference's data a walk stalls inside a row; the reference
    kernel then never ends. The plain version stops that row after
    MAX_BURSTS bursts of 4 steps and ends."""
    cmds, _ = pt.synth_cmds(8)
    cmds_g = cmds.reshape(1, 8, pt.R_ROWS, pt.LANES).transpose(0, 2, 1, 3).copy()
    clen = _t(np.full((1, 8, pt.LANES), pt.NCP, np.int32))
    rec, meta = pt.walk8(pt.R_ROWS, clen, _t(cmds_g))
    monkeypatch.setattr(pt, "MAX_BURSTS", pt.MAX_BURSTS + 4)
    _, capped = pt.walk8(pt.R_ROWS, clen, _t(cmds_g))
    assert rec.shape == (1, pt.T_TILES, 8, pt.LANES) and int(meta[0, 0, 0]) > 0
    assert not torch.equal(meta, capped), "no walk reached the burst cap"


def test_chain_gather_and_reduce_differ():
    """``reduce`` sums, per sublane, the window's lanes whose own index
    equals the lane: a broadcast scalar, not the gather."""
    x = _t(np.random.default_rng(0).integers(0, 1 << 20, (1, 8, pt.LANES)).astype(np.int32))
    assert not torch.equal(pt.chain(50, x, "gather"), pt.chain(50, x, "reduce"))


def test_drain_gather_and_logroll_rotate_opposite_ways():
    q0, r, fld, src = (_t(a) for a in drain_inputs())
    a, b = pt.drain(64, q0, r, fld, src, "gather"), pt.drain(64, q0, r, fld, src, "logroll")
    assert int((a != b).sum()) > 1000


# ---------------------------------------------------------------- wrappers and tool


@pytest.fixture(scope="module")
def cpu_probes():
    return {p.name: p for p in tool.probes("all", torch.device("cpu"))}


def test_tool_builds_the_scripts_probes(cpu_probes):
    """The script's knobs; the gate is the high knob but for P1 and P5,
    whose plain versions step through every iteration."""
    ps = cpu_probes
    assert all(p.gate == p.hi for p in ps.values() if p.kernel not in ("chain", "scalar_loop"))
    assert all(p.gate < p.lo for p in ps.values() if p.kernel in ("chain", "scalar_loop"))
    assert len(ps) == 7 + 2 + 3 + 8 + 3
    assert {p.kernel for p in ps.values()} == set(cuda_probes.KERNELS)
    assert [(p.lo, p.hi) for p in ps.values() if p.kernel == "chain"] == [(200_000, 1_000_000)] * 7
    assert (ps["P2 walk8 row-lockstep"].lo, ps["P2 walk8 row-lockstep"].hi) == (pt.R_ROWS // 2, pt.R_ROWS)
    assert (ps["P4 drain serial"].lo, ps["P4 drain serial"].hi) == (pt.NREC // 4, pt.NREC)
    assert [(p.lo, p.hi) for p in ps.values() if p.kernel == "scalar_loop"] == [(100_000, 900_000)] * 8
    assert (ps["P6 drain2nd when"].lo, ps["P6 drain2nd when"].hi) == (pt.WHEN_RECORDS * 8, pt.WHEN_RECORDS * 64)


def test_tool_counts_the_tags_the_walks_take(cpu_probes):
    """The slope's step counts: P3's live steps are those of its plain
    version's meta, and the rows of P2 hold every tag of the chains."""
    p2, p3 = cpu_probes["P2 walk8 row-lockstep"], cpu_probes["P3 scalar walk"]
    cmds = p3.args[1]
    for knob in (0, 1):
        meta = pt.walk_scalar(knob, p3.args[0][:8], cmds[:8])
        total, first = p3.steps(knob)
        assert first == int(meta[0, 0, 1])
    _, tags = pt.synth_cmds(64, max_advance=7)
    assert p2.steps(pt.R_ROWS) == (int(tags.sum()), int(tags[:8].sum()))
    assert p2.steps(0) == (0, 0)


@pytest.mark.parametrize("kernel", sorted(cuda_probes.KERNELS))
def test_wrappers_take_the_plain_version_on_the_cpu(cpu_probes, kernel):
    """On CPU tensors each wrapper is its plain version and launches
    nothing; the gate holds it against the plain version as it holds the
    kernel on the card (here at a small knob: on the CPU the wrapper is the
    plain version, and P6's high knob is 262,144 records)."""
    p = next(p for p in cpu_probes.values() if p.kernel == kernel)
    before = profiling.counters()
    small = dataclasses.replace(p, gate=min(p.gate, 64))
    got = tool.gate(small) if kernel not in ("walk8", "walk_scalar") else None
    assert got is None or (got["max_abs_err"] == 0 and got["plain_knob"] == small.gate and got["kernel_ms"] > 0)
    knob = {"walk_scalar": 0, "drain": 64, "when_drain": 64}.get(kernel, 3)
    a, b = p.fn(knob, *p.args), p.plain(knob, *p.args)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)
    assert not probe_launches(profiling.since(before))
    with pytest.raises(ValueError, match="on the card"):
        p.fn(knob, *p.args, cycles=torch.zeros(1, dtype=torch.int64))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((2, 8, pt.LANES), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_probes.chain(1, x, "gather")
    with pytest.raises(TypeError):
        cuda_probes.chain(1, x[:1].long(), "gather")
    with pytest.raises(ValueError, match="mode"):
        cuda_probes.chain(1, x[:1], "scatter")
    with pytest.raises(ValueError, match="knob"):
        cuda_probes.chain(-1, x[:1], "gather")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_probes.chain(1, torch.zeros((1, pt.LANES, 8), dtype=torch.int32).transpose(1, 2), "alu")
    clen = torch.full((1, 8, pt.LANES), pt.NCP, dtype=torch.int32)
    cmds = torch.zeros((1, pt.R_ROWS, 8, pt.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="knob"):
        cuda_probes.walk8(pt.R_ROWS + 1, clen, cmds)
    with pytest.raises(ValueError, match="variant"):
        cuda_probes.scalar_loop(10, torch.zeros(1024, dtype=torch.int32), 5, 1, False, False)
    with pytest.raises(ValueError, match="knob"):
        cuda_probes.scalar_loop((1 << 30) + 1, torch.zeros(1024, dtype=torch.int32), 4, 1, False, False)
    q0, r, fld, src = (torch.from_numpy(a) for a in drain_inputs())
    with pytest.raises(ValueError, match="knob"):
        cuda_probes.drain(pt.NREC + 8, q0, r, fld, src, "serial")
    with pytest.raises(TypeError):
        cuda_probes.drain(8, q0[:12], r[:12], fld[:1], src, "serial")


def _rows_both_define(q0, r, knob, nsrc, mode):
    """The output rows that no record with a row outside its array reaches
    under either reading of such a row: the port clamps it into the array;
    the reference in interpret mode reads a negative source row from the
    end, stores to a negative row r at row r + S + 9 (row 0 below -S - 9)
    and drops a store past the output's end."""
    nrec = knob if mode == "serial" else knob // 8 * 8
    ks = (0, 1, 2) if mode == "serial" else (0,)
    q = q0[:nrec].astype(np.int64)[:, None] + np.array(ks)
    rr = r[:nrec].astype(np.int64)[:, None] + np.array((0, 1) if mode == "serial" else (0,))
    q, rr = ((v + (1 << 31)) % (1 << 32) - (1 << 31) for v in (q, rr))  # int32 sums wrap
    out_rows = nsrc + 8
    bad = ((q < 0) | (q >= nsrc)).any(1) | ((rr < 0) | (rr >= out_rows)).any(1)
    reached = np.clip(np.concatenate([rr[bad], rr[bad] + out_rows + 1]), 0, out_rows - 1).ravel()
    keep = np.ones(out_rows, bool)
    keep[reached] = False
    return keep


@pytest.mark.parametrize("mode", pt.DRAIN_MODES)
def test_drain_gate_inputs(ref, mode):
    """P4's card gate beside the script's inputs, against the script's
    kernel: fields drawn per lane with every fourth record's row repeated by
    the next, drained alike; and the same with q0 and r at the edge rows,
    where the two agree on every output row that no record with a row
    outside its array reaches (such rows are the port's convention, which
    the plain version and the kernels share: clamped into the array)."""
    (q0, r, fld, src), (eq0, er, efld, _) = tool.drain_gate_inputs()
    assert (fld != fld[:, :, :1]).any() and (r[1::4] == r[::4]).all()
    assert set(tool.DRAIN_EDGE_Q0) <= set(eq0.tolist()) and set(tool.DRAIN_EDGE_ROWS) <= set(er.tolist())
    assert {(1 << 31) - 2, (1 << 31) - 1} <= set(eq0[:256:5].tolist()) and efld is fld
    want = _drain_kernel(ref, mode)(_knob(256), *(jnp.asarray(a) for a in (q0, r, fld, src)))
    _eq(pt.drain(256, _t(q0), _t(r), _t(fld), _t(src), mode), want)
    want = np.asarray(_drain_kernel(ref, mode)(_knob(256), *(jnp.asarray(a) for a in (eq0, er, fld, src))))
    keep = _rows_both_define(eq0, er, 256, src.shape[0], mode)
    assert keep.sum() > 0.8 * keep.size
    got = pt.drain(256, _t(eq0), _t(er), _t(fld), _t(src), mode).numpy()
    np.testing.assert_array_equal(got[keep], want[keep])
    assert all(len(p.gate_args) == 2 for p in tool.drains(torch.device("cpu")))


def test_drain_serial_wraps_q0_near_int_max(ref):
    """The serial drain reads rows q0, q0 + 1 and q0 + 2; the script adds
    them in int32, so at q0 = INT_MAX - 1 and INT_MAX they wrap to INT_MIN
    and clamp to row 0, as the kernel does (its g++ emulation holds it to
    the same rows) and the plain version does: the script is held to the
    plain version given the rows the wrap picks, and to the plain version
    on the raw rows."""
    q0, r, fld, src = tool.drain_gate_inputs()[0]
    q0[::3] = np.resize(np.array([(1 << 31) - 3, (1 << 31) - 2, (1 << 31) - 1], np.int32), q0[::3].shape)
    knob, rows = 64, src.shape[0] + 8
    want = np.asarray(_drain_kernel(ref, "serial")(_knob(knob), *(jnp.asarray(a) for a in (q0, r, fld, src))))
    q = (q0[:knob].astype(np.int64)[:, None] + np.arange(3) + (1 << 31)) % (1 << 32) - (1 << 31)
    wsrc = np.concatenate([src[np.clip(q, 0, src.shape[0] - 1).reshape(-1)], np.zeros_like(src)])
    wq0 = np.arange(q0.size, dtype=np.int32) * 3
    got = pt.drain(knob, _t(wq0), _t(r), _t(fld), _t(wsrc), "serial").numpy()
    assert (got[rows:] == pt.INT_MIN).all()
    np.testing.assert_array_equal(got[:rows], want)
    np.testing.assert_array_equal(pt.drain(knob, *(_t(a) for a in (q0, r, fld, src)), "serial").numpy(), want)


def test_l2_read_on_the_cpu_is_the_xor():
    """The one-block read's plain version, which its wrapper takes for a CPU
    tensor without counting a launch; sizes not a whole number of tiles are
    refused."""
    x = torch.from_numpy(np.random.default_rng(3).integers(-(1 << 31), 1 << 31, 2 * cuda_probes.READ_TILE)
                         .astype(np.int32))
    want = int(np.bitwise_xor.reduce(x.numpy()))
    before = profiling.counters()
    assert cuda_probes.l2_read(x).tolist() == [want] == pt.xor_words(x).tolist()
    assert not probe_launches(profiling.since(before))
    assert pt.xor_words(x[:3]).tolist() == [int(np.bitwise_xor.reduce(x[:3].numpy()))]
    with pytest.raises(TypeError):
        cuda_probes.l2_read(x[:1000])


def test_wrappers_copy_a_misaligned_tensor_before_a_launch():
    """The kernels copy rows 16 bytes a piece: a tensor whose data does not
    start on 16 bytes is copied (an aligned one is passed as it is)."""
    x = torch.arange(9, dtype=torch.int32)
    assert cuda_probes._aligned16(x) is x
    y = x[1:]
    assert y.data_ptr() % 16
    z = cuda_probes._aligned16(y)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, y)


def test_gate_parent_falls_back_to_the_scripts_inputs(cpu_probes, capsys):
    """A parent's copy that differs from the plain version only on the
    inputs beside the script's is gated on the script's inputs alone, and
    says so; one that differs on the script's inputs still fails."""
    p = dataclasses.replace(cpu_probes["P4 drain8 gather"], gate=64)
    args = p.args

    def older(knob, *a):  # right on the script's inputs only
        out = p.plain(knob, *a)
        return out if all(x is y for x, y in zip(a, args)) else out + 1

    tool.gate_parent(dataclasses.replace(p, fn=older))
    assert "on the script's inputs alone" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="differ"):
        tool.gate_parent(dataclasses.replace(p, fn=lambda knob, *a: p.plain(knob, *a) + 1))


def test_walk8_wrapper_refuses_a_length_that_varies_over_lanes():
    """P2 takes one length a walk: a group whose lengths vary over a walk's
    lanes gets meta (-1, -1) and INT_MIN records on the CPU as on the card
    (the g++ emulation pins the kernel's side); the other groups are
    walked."""
    cmds = pt.synth_cmds(16, seed=1, max_advance=7)[0]
    cmds_g = _t(cmds.reshape(2, 8, pt.R_ROWS, pt.LANES).transpose(0, 2, 1, 3).copy())
    clen = torch.full((2, 8, pt.LANES), pt.NCP, dtype=torch.int32)
    clen[0, 2, 77] = 100
    rec, meta = cuda_probes.walk8(20, clen, cmds_g)
    assert meta[0].tolist() == [[-1, -1]] and bool((rec[0] == pt.INT_MIN).all())
    p_rec, p_meta = pt.walk8(20, clen[1:], cmds_g[1:])
    assert torch.equal(meta[1:], p_meta) and torch.equal(rec[1:], p_rec)
    assert int(p_meta[0, 0, 0]) > 0


def test_tool_needs_a_card():
    assert tool.main(["walks"]) == 2
    assert tool.main(["sideways"]) == 2


def test_tool_parent_needs_a_path(capsys):
    assert tool.main(["chains", "--parent"]) == 2
    assert "--parent" in capsys.readouterr().err


def test_tool_parent_refuses_a_missing_file(tmp_path, capsys):
    """A missing copy is refused before anything is built or timed."""
    assert tool.main(["when", "--parent", str(tmp_path / "missing.cu")]) == 2
    assert "no file" in capsys.readouterr().err


def test_tool_parent_needs_a_card(tmp_path, capsys):
    copy = tmp_path / "exp_vector_walk.cu"
    copy.write_text((kernels.CSRC / "exp_vector_walk.cu").read_text())
    assert tool.main(["chains", "--parent", str(copy)]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_tool_routes_a_copy_to_the_wrappers_lib(cpu_probes):
    """``on_copy`` hands the copy to the wrapper as ``lib``; on CPU tensors
    the wrappers refuse it (the plain version takes no copy)."""
    p = tool.on_copy(cpu_probes["P1 gather-select chain G=1"], lib=object())
    assert p.fn.keywords["lib"] is not None and p.plain is cpu_probes["P1 gather-select chain G=1"].plain
    with pytest.raises(ValueError, match="on the card"):
        p.fn(3, *p.args)
