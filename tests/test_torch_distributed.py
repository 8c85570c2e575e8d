"""The port's distributed stepper against the reference's.

One subprocess (8 forced host devices, as `tests/test_distributed.py`
runs the reference) runs `repro.distributed.stepper.run_distributed` with
plan=None, synchronous and compressed on a (2, 2, 2) mesh and overlapped on
a 4x2 mesh, for the four paper ops and a custom 9-tap op, and
`repro.kernels.adjoint.distributed_vjp` with plan=None, and saves its
outputs as numpy. The port's same calls on CPU shards (a mesh of
``[cpu] * 8``) must land within `op.tolerance("f32")` of them; compressed
runs within the reference's 5e-2 of naive and within 1e-5 of the
reference's own compressed output. The reference's plan=MWDPlan route does
not run under this jax (``shard_map(check_rep=...)``), so the port's K1
route (K1's plain version on the CPU) is held bitwise against its own
synchronous schedule and `ops.naive`, and within tolerance of the
reference's `run_naive`, in process.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import stencils as rst
from repro.distributed import compression as rcomp
from repro_torch.core import ir as tir
from repro_torch.core import registry as treg
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import stepper as tstep
from repro_torch.kernels import adjoint as tadj
from repro_torch.kernels import ops as tops
from repro_torch.launch import mesh as tmesh

CPU = torch.device("cpu")
NAMES = list(tst.SPECS) + ["dist-custom9"]
MODES = [("2x2x2", "sync"), ("2x2x2", "compress"), ("4x2", "overlap")]
VJP_OPS = ("7pt-var", "25pt-const")
VJP_GRID = {1: (8, 8, 12), 4: (32, 16, 18)}
VJP_STEPS = 2
BUDGET = 5e-2


def custom9(irmod):
    """`tests/test_distributed.py`'s user-defined 9-tap op."""
    taps = [irmod.Tap(0, 0, 0, irmod.array(0))]
    taps += [irmod.Tap(*o, irmod.array(k + 1)) for k, o in enumerate(
        [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
         (0, 0, 1), (0, -1, -1), (0, 1, 1)])]
    return irmod.StencilOp("dist-custom9", tuple(taps), coeff_scale=0.08)


def case(mode, radius):
    """(grid, steps) of a mode: the reference tests' grids, a trailing
    partial super-step for the synchronous and compressed runs."""
    if mode == "overlap":
        return ((24, 16, 8) if radius == 1 else (72, 36, 16)), 4
    return ((8, 8, 16) if radius == 1 else (32, 16, 18)), 5


SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.dirname(sys.argv[3]))
import jax, numpy as np
from repro.core import ir, stencils as st
from repro.distributed import stepper
from repro.kernels import adjoint
from test_torch_distributed import (MODES, VJP_GRID, VJP_OPS, VJP_STEPS,
                                    case, custom9)
meshes = {"2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model")),
          "4x2": jax.make_mesh((4, 2), ("data", "model"))}
ops = dict(st.SPECS)
ops["dist-custom9"] = custom9(ir)
# distributed_vjp's bookkeeping is host-level jnp on the global arrays;
# under this jax a sharded result refuses host-level indexing, so the
# stepper's results come back unsharded (the same values)
_run = stepper.run_distributed
stepper.run_distributed = lambda *a, **k: tuple(
    jax.numpy.asarray(np.asarray(x)) for x in _run(*a, **k))
out = {}
for mname, mode in MODES:
    for name, spec in ops.items():
        grid, steps = case(mode, spec.radius)
        state, coeffs = st.make_problem(spec, grid, seed=7)
        got = stepper.run_distributed(spec, meshes[mname], state, coeffs,
                                      steps, t_block=2,
                                      overlap=mode == "overlap",
                                      compress=mode == "compress")
        for i in (0, 1):
            out[f"{mname}|{mode}|{name}|{i}"] = np.asarray(got[i])
for name in VJP_OPS:
    spec = st.SPECS[name]
    grid = VJP_GRID[spec.radius]
    state, coeffs = st.make_problem(spec, grid, seed=5)
    w = np.random.default_rng(6).standard_normal(grid).astype(np.float32)
    outs, vjp = adjoint.distributed_vjp(spec, meshes["2x2x2"], state,
                                        coeffs, VJP_STEPS, t_block=2)
    grads = vjp((w, np.zeros_like(w)))
    for i, g in enumerate(grads):
        if g is not None:
            out[f"vjp|{name}|{i}"] = np.asarray(g)
    out[f"vjp|{name}|out"] = np.asarray(outs[0])
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs, from one subprocess."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, src, path, os.path.abspath(__file__)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "REFERENCE_DONE" in proc.stdout
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def ops_pair(name):
    if name == "dist-custom9":
        return custom9(rir), custom9(tir)
    return rst.SPECS[name], tst.SPECS[name]


def problem(name, grid, seed):
    rspec, tspec = ops_pair(name)
    state, coeffs = rst.make_problem(rspec, grid, seed=seed)
    return rspec, tspec, state, coeffs, tir.problem_from_numpy(
        tspec, state, coeffs, device="cpu")


def cpu_mesh(name):
    if name == "2x2x2":
        return tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                               devices=[CPU] * 8)
    if name == "4x2":
        return tmesh.make_debug_mesh((4, 2), devices=[CPU] * 8)
    return tmesh.make_debug_mesh((2, 2), devices=[CPU] * 4)


def within(got, want, tol):
    atol, rtol = tol
    want = np.asarray(want, np.float64)
    err = np.abs(got.double().numpy() - want)
    return bool((err <= atol + rtol * np.abs(want)).all()), float(err.max())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh_name,mode", MODES)
def test_plain_route_matches_reference(reference, name, mesh_name, mode):
    rspec, tspec = ops_pair(name)
    grid, steps = case(mode, tspec.radius)
    rspec, tspec, _, rcoeffs, (state, coeffs) = problem(name, grid, 7)
    got = tstep.run_distributed(tspec, cpu_mesh(mesh_name), state, coeffs,
                                steps, 2, overlap=mode == "overlap",
                                compress=mode == "compress")
    for i in (0, 1):
        want = reference[f"{mesh_name}|{mode}|{name}|{i}"]
        if mode == "compress":
            err = float(np.abs(got[i].numpy() - want).max())
            assert err <= 1e-5, (name, i, err)
        else:
            ok, err = within(got[i], want, tspec.tolerance("f32"))
            assert ok, (name, i, err)
    if mode == "compress":
        naive = tops.naive(tspec, state, coeffs, steps)
        assert float((got[0] - naive[0]).abs().max()) < BUDGET
        exact = tstep.run_distributed(tspec, cpu_mesh(mesh_name), state,
                                      coeffs, steps, 2)
        assert not torch.equal(exact[0], got[0])


@pytest.mark.parametrize("name", VJP_OPS)
def test_distributed_vjp_matches_reference(reference, name):
    spec = tst.SPECS[name]
    grid = VJP_GRID[spec.radius]
    _, tspec, _, _, (state, coeffs) = problem(name, grid, 5)
    w = torch.from_numpy(
        np.random.default_rng(6).standard_normal(grid).astype(np.float32))
    outs, vjp = tadj.distributed_vjp(tspec, cpu_mesh("2x2x2"), state,
                                     coeffs, VJP_STEPS, t_block=2)
    atol, rtol = tspec.tolerance("f32")
    ok, err = within(outs[0], reference[f"vjp|{name}|out"], (atol, rtol))
    assert ok, err
    grads = vjp((w, torch.zeros_like(w)))
    for i, g in enumerate(grads):
        key = f"vjp|{name}|{i}"
        if g is None:
            assert key not in reference
            continue
        want = reference[key]
        # the reference's gradcheck budget: 8·(atol + rtol·max(|ref|, 1))
        scale = max(float(np.abs(want).max()), 1.0)
        err = float(np.abs(g.double().numpy() - want).max())
        assert err <= 8 * (atol + rtol * scale), (name, i, err)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_err", [False, True])
def test_quantize_slab_bitwise_equals_reference(seed, with_err):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 6, 10)) * 3).astype(np.float32)
    # exact half-way points: both round half to even
    x[0, 0, :5] = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32) * (
        np.abs(x).max() / 127.0)
    e = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    rq, rs, re = rcomp.quantize_slab(jnp.asarray(x),
                                     jnp.asarray(e) if with_err else None)
    tq, ts, te = tcomp.quantize_slab(torch.from_numpy(x),
                                     torch.from_numpy(e) if with_err
                                     else None)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    np.testing.assert_array_equal(
        tcomp.dequantize_slab(tq, ts, torch.float32).numpy(),
        np.asarray(rcomp.dequantize_slab(rq, rs, jnp.float32)))


def test_compressed_pmean_matches_reference():
    """The gradient path: the reference's `compressed_pmean` over a vmapped
    axis of 4 members against the port's over the 4 members' tensors."""
    import jax
    rng = np.random.default_rng(1)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    e = (rng.standard_normal((4, 64)) * 0.01).astype(np.float32)
    r_out, r_err = jax.vmap(
        lambda a, b: rcomp.compressed_pmean(a, b, "i"), axis_name="i")(
        jnp.asarray(g), jnp.asarray(e))
    t_out, t_err = tcomp.compressed_pmean(
        [torch.from_numpy(r) for r in g], [torch.from_numpy(r) for r in e])
    np.testing.assert_allclose(np.stack([t.numpy() for t in t_out]),
                               np.asarray(r_out), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.stack([t.numpy() for t in t_err]),
                               np.asarray(r_err), rtol=1e-6, atol=1e-7)
    assert tcomp.compression_ratio(torch.float32) == 4.0
    assert tcomp.init_error_state({"a": torch.ones(3)})["a"].sum() == 0


@pytest.fixture
def registry_file(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv(treg.ENV_VAR, path)
    return path


@pytest.mark.parametrize("name", list(tst.SPECS))
@pytest.mark.parametrize("plan", ["explicit", "auto"])
@pytest.mark.parametrize("steps", [4, 5])
def test_k1_route_bitwise(registry_file, name, plan, steps):
    """K1 per shard (its plain version here): synchronous == overlapped ==
    ops.naive bitwise on a 2x2 mesh, a trailing partial super-step at 5
    steps, second-order ops included; within tolerance of the reference's
    single-device `run_naive`."""
    rspec, tspec, rstate, rcoeffs, (state, coeffs) = problem(
        name, (24, 16, 8) if tst.SPECS[name].radius == 1 else (40, 40, 12),
        3)
    p = MWDPlan(d_w=2 * tspec.radius, n_f=1) if plan == "explicit" else plan
    mesh = cpu_mesh("2x2")
    sync = tstep.run_distributed(tspec, mesh, state, coeffs, steps, 2,
                                 plan=p)
    ovl = tstep.run_distributed(tspec, mesh, state, coeffs, steps, 2,
                                plan=p, overlap=True)
    naive = tops.naive(tspec, state, coeffs, steps)
    for a, b, c in zip(sync, ovl, naive):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    want = rst.run_naive(rspec, rstate, rcoeffs, steps)
    for i in (0, 1):
        ok, err = within(sync[i], want[i], tspec.tolerance("f32"))
        assert ok, err


@pytest.mark.parametrize("name", ["7pt-const", "25pt-var"])
def test_k1_route_compressed_within_budget(registry_file, name):
    _, tspec, _, _, (state, coeffs) = problem(
        name, (24, 16, 8) if tst.SPECS[name].radius == 1 else (40, 40, 12),
        3)
    mesh = cpu_mesh("2x2")
    plan = MWDPlan(d_w=2 * tspec.radius, n_f=1)
    naive = tops.naive(tspec, state, coeffs, 4)
    for ovl in (False, True):
        got = tstep.run_distributed(tspec, mesh, state, coeffs, 4, 2,
                                    plan=plan, compress=True, overlap=ovl)
        assert float((got[0] - naive[0]).abs().max()) < BUDGET


def test_explicit_plan_wider_than_the_shard_raises():
    _, tspec, _, _, (state, coeffs) = problem("7pt-const", (8, 8, 16), 1)
    mesh = cpu_mesh("2x2")
    assert tstep.local_extended_shape(tspec, mesh, (8, 8, 16), 2) == \
        (8, 8, 20)
    with pytest.raises(ValueError, match="exceeds the per-shard extended y"):
        tstep.run_distributed(tspec, mesh, state, coeffs, 2, 2,
                              plan=MWDPlan(d_w=16, n_f=2))
    with pytest.raises(ValueError, match="MWDPlan or 'auto'"):
        tstep.run_distributed(tspec, mesh, state, coeffs, 2, 2, plan="best")


def test_auto_plan_keys_on_the_shard(registry_file, monkeypatch):
    """plan="auto" resolves against the per-shard extended block and caps
    an oversized tuned d_w (the reference's shard-key regression): the
    registry holds only the shard key, with d_w 32, and the search is
    stubbed to fail."""
    from repro_torch.core import autotune
    spec = tst.SPECS["7pt-const"]
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                           devices=[CPU] * 8)
    shape_e = tstep.local_extended_shape(spec, mesh, (8, 8, 16), 2)
    assert shape_e == (6, 8, 20)
    treg.default_registry().put(spec, shape_e, MWDPlan(d_w=32, n_f=2), 9.0)

    def no_search(*a, **k):
        raise AssertionError("plan='auto' resolved off the per-shard key")

    monkeypatch.setattr(autotune, "autotune", no_search)
    plan, source = tstep.resolve_shard_plan(spec, mesh, (8, 8, 16), 2)
    assert source.startswith("registry") and plan.d_w == 8
    state, coeffs = tst.make_problem(spec, (8, 8, 16), seed=11, device="cpu")
    got = tstep.run_distributed(spec, mesh, state, coeffs, 4, 2, plan="auto")
    want = tops.naive(spec, state, coeffs, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_halo_exchange_copies_into_receive_buffers():
    """Every received slab is a fresh buffer; edge clamps at the global
    edges; the two-phase exchange brings the corners."""
    from repro_torch.distributed import halo
    x = torch.arange(8 * 6 * 3, dtype=torch.float32).reshape(8, 6, 3)
    gs = tstep.GridSharding(cpu_mesh("2x2"))
    grid = gs.shard(x)
    parts = halo.exchange_axis_parts([grid[0][0], grid[1][0]], 0, 2)
    assert torch.equal(parts[1][0], grid[0][0][-2:])
    assert parts[1][0].data_ptr() != grid[0][0].data_ptr()
    assert torch.equal(parts[0][0], grid[0][0][:1].expand(2, 3, 3))
    ext = halo.exchange_2d(grid, 1)
    full = torch.nn.functional.pad(x[None, None], (0, 0, 1, 1, 1, 1),
                                   mode="replicate")[0, 0]
    assert torch.equal(ext[1][1], full[4:10, 3:8])
    with pytest.raises(ValueError, match="halo depth"):
        halo.exchange_axis([grid[0][0], grid[1][0]], 0, 5)
