"""The port's examples (`repro_torch.examples`) on the CPU against the
reference's library calls on the same inputs.

Each example's `main(["--device", "cpu"])` runs at its reference's grid;
its outputs are held against the reference's `run_naive` on the numbers
the reference's `make_problem` (or the example's own numpy seed) draws,
within ``op.tolerance("f32")``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import stencils as rst
from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.examples import (custom_stencil, distributed_stencil,
                                  heat3d_train, quickstart)


def carried(rspec, tspec, shape, seed):
    state, coeffs = rir.make_problem(rspec, shape, seed=seed)
    np_state = tuple(np.asarray(s) for s in state)
    np_coeffs = jax.tree_util.tree_map(np.asarray, coeffs)
    return ((state, coeffs),
            tir.problem_from_numpy(tspec, np_state, np_coeffs, device="cpu"))


def assert_close(got, want, tol):
    atol, rtol = tol
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def aniso11_reference():
    """`repro_torch.examples.custom_stencil.OP`'s taps in the reference IR."""
    taps = [rir.Tap(0, 0, 0, rir.array(0))]
    for ax, slot in ((0, 1), (1, 2)):
        off = [0, 0, 0]
        off[ax] = 1
        taps += [rir.Tap(*off, rir.array(slot)),
                 rir.Tap(*[-v for v in off], rir.array(slot))]
    for d in (1, 2, 3):
        taps += [rir.Tap(0, 0, d, rir.const(d - 1)),
                 rir.Tap(0, 0, -d, rir.const(d - 1))]
    return rir.StencilOp("aniso11", tuple(taps),
                         default_scalars=(0.08, 0.04, 0.02),
                         coeff_scale=0.08)


def test_quickstart_main_agrees_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    report = quickstart.main(["--device", "cpu"])
    assert list(report) == list(tst.SPECS)
    for errs in report.values():
        assert set(errs) == {"spatial-kernel", "ghostzone-kernel",
                             "mwd-kernel", "mwd-auto", "mwd-executor"}
        assert all(e < quickstart.TOLERANCE for e in errs.values())


@pytest.mark.parametrize("name", list(rst.SPECS))
def test_quickstart_methods_match_reference_naive(name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    rspec, tspec = rst.SPECS[name], tst.SPECS[name]
    (rstate, rcoeffs), (state, coeffs) = carried(
        rspec, tspec, quickstart.CPU_GRID, 0)
    want = rst.run_naive(rspec, rstate, rcoeffs, quickstart.STEPS)
    outs = quickstart.run_methods(tspec, state, coeffs)
    assert len(outs) == 6
    for method, (cur, prev) in outs.items():
        assert_close(cur, want[0], tspec.tolerance("f32"))
        assert_close(prev, want[1], tspec.tolerance("f32"))


def test_custom_stencil_matches_reference_naive(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    rop, op = aniso11_reference(), custom_stencil.OP
    assert op.fingerprint == rop.fingerprint
    assert (op.flops_per_lup, op.n_streams, op.radii) == (
        rop.flops_per_lup, rop.n_streams, rop.radii)
    assert tir.resolve_op("repro_torch.examples.custom_stencil:OP") is op
    (rstate, rcoeffs), (state, coeffs) = carried(
        rop, op, custom_stencil.CPU_GRID, 0)
    want = rst.run_naive(rop, rstate, rcoeffs, custom_stencil.STEPS)
    outs = custom_stencil.run_methods(state, coeffs)
    for cur, _ in outs.values():
        assert_close(cur, want[0], op.tolerance("f32"))
    errs = custom_stencil.main(["--device", "cpu"])
    assert set(errs) == {"mwd-auto", "mwd-fused"}
    assert all(e < custom_stencil.TOLERANCE for e in errs.values())


def heat_args(ckpt, steps, *extra):
    return ["--device", "cpu", "--n", "16", "--steps", str(steps),
            "--span", "12", "--ckpt-every", "24", "--ckpt", str(ckpt),
            *extra]


def test_heat3d_verifies_against_reference_naive(tmp_path):
    rep = heat3d_train.main(heat_args(tmp_path / "ck", 48, "--verify"))
    assert rep["bitwise"] and rep["start"] == 0
    spec = rst.SPECS["7pt-const"]
    u0 = jnp.asarray(np.random.default_rng(3).standard_normal((16,) * 3),
                     jnp.float32)
    coeffs = (jnp.float32(1 - 6 * heat3d_train.KAPPA),
              jnp.float32(heat3d_train.KAPPA))
    want = rst.run_naive(spec, (u0, u0), coeffs, 48)
    tol = tst.SPECS["7pt-const"].tolerance("f32")
    assert_close(rep["state"][0], want[0], tol)
    assert_close(rep["state"][1], want[1], tol)


def test_heat3d_resume_is_bit_identical(tmp_path):
    whole = heat3d_train.main(heat_args(tmp_path / "a", 48))
    heat3d_train.main(heat_args(tmp_path / "b", 24))          # stops at 24
    resumed = heat3d_train.main(heat_args(tmp_path / "b", 48, "--resume"))
    assert resumed["start"] == 24
    for a, b in zip(whole["state"], resumed["state"]):
        assert torch.equal(a, b)


def test_distributed_example_matches_naive(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    rep = distributed_stencil.main(["--device", "cpu",
                                    "--ckpt", str(tmp_path / "ck")])
    assert rep["err"] == 0.0
    assert (tmp_path / "ck").is_dir()
    rspec, tspec = rst.SPECS["7pt-var"], tst.SPECS["7pt-var"]
    (rstate, rcoeffs), _ = carried(rspec, tspec, distributed_stencil.CPU_GRID,
                                   11)
    want = rst.run_naive(rspec, rstate, rcoeffs,
                         distributed_stencil.T1 + distributed_stencil.T2)
    assert_close(rep["out"][0], want[0], tspec.tolerance("f32"))
    assert_close(rep["out"][1], want[1], tspec.tolerance("f32"))


def test_train_lm_trains_three_reduced_steps(tmp_path):
    from repro_torch.distributed import checkpoint
    from repro_torch.examples import train_lm
    state = train_lm.main(["--device", "cpu", "--steps", "3", "--batch",
                           "2", "--seq", "32", "--ckpt", str(tmp_path),
                           "--ckpt-every", "3"])
    assert int(state["step"]) == 3
    assert checkpoint.all_steps(str(tmp_path)) == [3]
    assert all(bool(torch.isfinite(p).all())
               for p in state["params"]["blocks"][0]["ffn"].values())
