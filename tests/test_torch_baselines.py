"""The port's baselines (`ops.spatial`, `ops.ghostzone`) vs the JAX reference.

The reference runs its Pallas kernels in interpret mode, as its own tests
do, at the shapes and parameters of tests/test_kernels.py; the port runs
the kernels' plain versions on CPU tensors. Inputs come from the
reference's `make_problem`, carried across with `problem_from_numpy`.
Parity across frameworks is held to `op.tolerance(dtype)`; the port's own
invariants (both methods == `ops.naive`, ``n_steps = 0`` identity, a short
last pass == a sequence of full passes) are held bitwise.
"""

import jax.numpy as jnp
import pytest
import torch
from test_torch_mwd import (aniso11, assert_bitwise, assert_within, carry,
                            ops_pair)

from repro.core import stencils as rst
from repro.kernels import ops as rops
from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_fused as tfused
from repro_torch.kernels import stencil_sweep as tsweep

SHAPES_R1 = [(6, 10, 12), (10, 20, 24), (9, 17, 31)]
SHAPES_R4 = [(10, 18, 14), (13, 21, 18)]
NAMES = list(rst.SPECS) + ["aniso11"]


def _shapes(name):
    radius = 3 if name == "aniso11" else rst.SPECS[name].radius
    return SHAPES_R1 if radius == 1 else SHAPES_R4


def _tspec(name):
    return aniso11(tir) if name == "aniso11" else tst.SPECS[name]


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [(n, s) for n in NAMES
                                        for s in _shapes(n)])
@pytest.mark.parametrize("t_steps", [1, 3])
def test_spatial_matches_reference(name, shape, t_steps):
    rspec, tspec = ops_pair(name)
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, seed=1)
    want = rops.spatial(rspec, rstate, rcoeffs, t_steps, bz=4)
    got = tops.spatial(tspec, state, coeffs, t_steps, bz=4)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("t_steps,t_block", [(2, 2), (5, 3)])
def test_ghostzone_matches_reference(name, t_steps, t_block):
    rspec, tspec = ops_pair(name)
    shape = SHAPES_R1[1] if tspec.radius == 1 else SHAPES_R4[0]
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, seed=3)
    want = rops.ghostzone(rspec, rstate, rcoeffs, t_steps, t_block=t_block,
                          bz=4, by=8)
    got = tops.ghostzone(tspec, state, coeffs, t_steps, t_block=t_block,
                         bz=4, by=8)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))


@pytest.mark.parametrize("method,kw", [
    ("spatial", dict(bz=4)), ("ghostzone", dict(t_block=2, bz=4, by=8))])
def test_baselines_bf16_match_reference(method, kw):
    rspec, tspec = ops_pair("7pt-const")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (8, 16, 16),
                                               jnp.bfloat16, seed=5)
    want = rops.METHODS[method](rspec, rstate, rcoeffs, 2, **kw)
    got = tops.METHODS[method](tspec, state, coeffs, 2, **kw)
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("bf16"))


def test_methods_match_reference():
    assert set(tops.METHODS) == set(rops.METHODS)


# ---------------------------------------------------------------------------
# The port's own invariants, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_baselines_bitwise_equal_naive(name):
    spec = _tspec(name)
    state, coeffs = tst.make_problem(spec, _shapes(name)[-1], seed=7,
                                     device="cpu")
    naive = tops.naive(spec, state, coeffs, 5)
    assert_bitwise(tops.spatial(spec, state, coeffs, 5, bz=4), naive)
    assert_bitwise(tops.spatial(spec, state, coeffs, 5), naive)
    assert_bitwise(tops.ghostzone(spec, state, coeffs, 5, t_block=3, bz=4,
                                  by=8), naive)
    assert_bitwise(tops.ghostzone(spec, state, coeffs, 5), naive)


@pytest.mark.parametrize("method", ["spatial", "ghostzone"])
def test_zero_steps_is_identity(method):
    spec = tst.SPECS["25pt-const"]
    state, coeffs = tst.make_problem(spec, (10, 18, 14), seed=1, device="cpu")
    out = tops.METHODS[method](spec, state, coeffs, 0)
    assert out[0] is state[0] and out[1] is state[1]


@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_short_last_pass_equals_full_pass_sequence(name):
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, _shapes(name)[0], seed=2,
                                     device="cpu")
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    got = tfused.run_fused(spec, state, arrays, scalars, 5, t_block=3, bz=4,
                           by=8)
    passes = tfused.fused_pass(spec, state, arrays, scalars, 3, bz=4, by=8)
    passes = tfused.fused_pass(spec, passes, arrays, scalars, 2, bz=4, by=8)
    assert_bitwise(got, passes)
    assert tfused.pass_lengths(5, 3) == [3, 2]
    assert tfused.pass_lengths(6, 3) == [3, 3]
    assert tfused.pass_lengths(0, 3) == []
    single = state
    for _ in range(5):
        single = tfused.fused_pass(spec, single, arrays, scalars, 1, bz=4,
                                   by=8)
    assert_bitwise(got, single)


def test_sweep_step_is_a_naive_step():
    spec = tst.SPECS["25pt-var"]
    state, coeffs = tst.make_problem(spec, (10, 18, 14), seed=4, device="cpu")
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    new, old = tsweep.sweep_step(spec, state, arrays, scalars, bz=3)
    assert old is state[0]
    assert_bitwise((new, old), tst.step(spec, state, coeffs))


def test_cpu_tensors_never_reach_the_baseline_kernels():
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    before = (tsweep.LAUNCHES.count, tfused.LAUNCHES.count)
    tops.spatial(spec, state, coeffs, 3)
    tops.ghostzone(spec, state, coeffs, 3, t_block=2)
    assert (tsweep.LAUNCHES.count, tfused.LAUNCHES.count) == before
    with pytest.raises(ValueError, match="CUDA"):
        tsweep.run_kernel(spec, state, arrays, scalars)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.run_kernel(spec, state, arrays, scalars, 2)


def test_baseline_argument_checks():
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    with pytest.raises(ValueError, match="bz"):
        tops.spatial(spec, state, coeffs, 2, bz=0)
    for kw in (dict(t_block=0), dict(bz=0), dict(by=0)):
        with pytest.raises(ValueError, match="t_block"):
            tops.ghostzone(spec, state, coeffs, 2, **kw)
    with pytest.raises(ValueError, match="coefficient streams"):
        tsweep.sweep_step(spec, state, arrays.double(), scalars)
    with pytest.raises(ValueError, match="disagree"):
        tfused.fused_pass(spec, (state[0], state[1][:-1]), arrays, scalars, 2)
    batched = tuple(s[None] for s in state)
    with pytest.raises(ValueError, match="nz, ny, nx"):
        tsweep.sweep_step(spec, batched, arrays[None], scalars)
    with pytest.raises(ValueError, match="nz, ny, nx"):
        tfused.fused_pass(spec, batched, arrays[None], scalars, 2)
