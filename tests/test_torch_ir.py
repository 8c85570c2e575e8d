"""The port's IR, precision, problems and schedule tables vs the JAX reference.

Inputs are made by the reference's `make_problem` and carried across as
numpy arrays (`problem_from_numpy`), so both packages compute on identical
numbers.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import precision as rprec
from repro.core import stencils as rst
from repro.core import tiling as rtil
from repro.kernels import ops as rops
from repro_torch.core import ir as tir
from repro_torch.core import precision as tprec
from repro_torch.core import stencils as tst
from repro_torch.core import tiling as ttil
from repro_torch.kernels import ops as tops

DTYPES = [("f32", jnp.float32), ("bf16", jnp.bfloat16), ("fp16", jnp.float16)]


def aniso11(irmod):
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [irmod.Tap(0, 0, 0, irmod.array(0)),
            irmod.Tap(-1, 0, 0, irmod.array(1)),
            irmod.Tap(1, 0, 0, irmod.array(1)),
            irmod.Tap(0, -1, 0, irmod.array(2)),
            irmod.Tap(0, 1, 0, irmod.array(2))]
    taps += [irmod.Tap(0, 0, s * d, irmod.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return irmod.StencilOp("aniso11", tuple(taps),
                           default_scalars=(0.08, 0.04, 0.02))


NAMES = list(rst.SPECS) + ["aniso11"]


def ops_pair(name):
    if name == "aniso11":
        return aniso11(rir), aniso11(tir)
    return rst.SPECS[name], tst.SPECS[name]


def carry(rspec, tspec, shape, dtype=jnp.float32, seed=0):
    state, coeffs = rir.make_problem(rspec, shape, dtype=dtype, seed=seed)
    np_state = tuple(np.asarray(s) for s in state)
    np_coeffs = jax.tree_util.tree_map(np.asarray, coeffs)
    return (state, coeffs), tir.problem_from_numpy(tspec, np_state, np_coeffs,
                                                   device="cpu")


def assert_within(got, want, tol):
    atol, rtol = tol
    g = got.double().numpy()
    w = np.asarray(want).astype(np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w)
    assert np.all(err <= atol + rtol * np.abs(w)), float(err.max())


# ---------------------------------------------------------------------------
# IR structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_fingerprint_and_analytics_equal_reference(name):
    rspec, tspec = ops_pair(name)
    assert tspec.fingerprint == rspec.fingerprint
    for attr in ("radius", "radii", "n_scalars", "n_coeff_arrays",
                 "flops_per_lup", "n_streams"):
        assert getattr(tspec, attr) == getattr(rspec, attr), attr
    got = [(c.kind, c.index, tuple(t.offset for t in ts))
           for c, ts in tspec.groups]
    want = [(c.kind, c.index, tuple(t.offset for t in ts))
            for c, ts in rspec.groups]
    assert got == want


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dt", ["f32", "bf16", "fp16", "f64"])
def test_tolerance_equals_reference(name, dt):
    rspec, tspec = ops_pair(name)
    assert tspec.tolerance(dt) == pytest.approx(rspec.tolerance(dt))


def test_precision_names_and_accumulators():
    for name in ("f32", "bf16", "fp16", "f64", "float32", "half", "double"):
        assert tprec.dtype_name(name) == rprec.dtype_name(name)
        assert tprec.word_bytes(name) == rprec.word_bytes(name)
        assert (float(tprec.finfo(name).eps)
                == float(rprec.finfo(name).eps))
    assert tprec.parse_dtype(None) == torch.float32
    assert tprec.parse_dtype(np.float16) == torch.float16
    assert tprec.parse_dtype(torch.bfloat16) == torch.bfloat16
    assert tprec.word_bytes() == rprec.word_bytes() == 4
    with pytest.raises(ValueError):
        tprec.parse_dtype("f8")
    for stream, acc in itertools.product(("f32", "bf16", "fp16"),
                                         ("auto", "native", "f32", "f64")):
        want = rprec.resolve_acc(stream, acc)
        got = tprec.resolve_acc(stream, acc)
        assert (got is None) == (want is None)
        if got is not None:
            assert tprec.dtype_name(got) == rprec.dtype_name(want)


def test_op_validation_matches_reference():
    bad = [
        dict(taps=()),
        dict(taps=(tir.Tap(0, 0, 0, tir.const(0)),)),
        dict(taps=(tir.Tap(1, 0, 0, tir.const(1)),)),
        dict(taps=(tir.Tap(1, 0, 0, tir.const(0)),), time_order=3),
        dict(taps=(tir.Tap(1, 0, 0, tir.const(0)),), scale=tir.array(0)),
        dict(taps=(tir.Tap(1, 0, 0, tir.const(0)),
                   tir.Tap(1, 0, 0, tir.const(0)))),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            tir.StencilOp("bad", **kw)
    with pytest.raises(ValueError):
        tir.Coeff("other", 0)


# ---------------------------------------------------------------------------
# Problems: same draws, carried across in every packing convention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_make_problem_draws_equal_reference(name, dt, jdt):
    rspec, tspec = ops_pair(name)
    shape = (5, 7, 9)
    (rstate, rcoeffs), _ = carry(rspec, tspec, shape, jdt, seed=3)
    (cur, prev), coeffs = tst.make_problem(tspec, shape, dtype=dt, seed=3,
                                           device="cpu")
    assert cur.dtype == tprec.parse_dtype(dt)
    np.testing.assert_array_equal(cur.float().numpy(),
                                  np.asarray(rstate[0]).astype(np.float32))
    np.testing.assert_array_equal(prev.float().numpy(),
                                  np.asarray(rstate[1]).astype(np.float32))
    rarr, rsca = rir.split_coeffs(rspec, rcoeffs)
    tarr, tsca = tir.split_coeffs(tspec, coeffs)
    assert tsca == tuple(float(x) for x in rsca)
    if rarr is None:
        assert tarr is None
    else:
        np.testing.assert_array_equal(tarr.float().numpy(),
                                      np.asarray(rarr).astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_problem_from_numpy_keeps_packing_convention(name):
    rspec, tspec = ops_pair(name)
    (_, rcoeffs), (state, coeffs) = carry(rspec, tspec, (5, 6, 8), seed=1)
    assert state[0].dtype == torch.float32 and state[0].device.type == "cpu"
    if tspec.n_coeff_arrays and tspec.n_scalars:
        arrays, scalars = coeffs
        assert isinstance(arrays, torch.Tensor)
        assert isinstance(scalars, tuple)
        assert all(isinstance(s, float) for s in scalars)
    elif tspec.n_coeff_arrays:
        assert isinstance(coeffs, torch.Tensor)
    else:
        assert isinstance(coeffs, tuple)
    arrays, scalars = tir.split_coeffs(tspec, coeffs)
    packed = tir.join_coeffs(tspec, arrays, scalars)
    assert type(packed) is type(coeffs)


def test_split_coeffs_batch_refuses_scalar_mismatch():
    spec = tst.SPECS["7pt-const"]
    with pytest.raises(ValueError, match="share"):
        tir.split_coeffs_batch(spec, [(0.4, 0.1), (0.4, 0.2)])
    with pytest.raises(ValueError):
        tir.split_coeffs_batch(spec, [])
    with pytest.raises(ValueError):
        tir.split_coeffs(spec, (0.4,))


# ---------------------------------------------------------------------------
# The generated sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_make_sweep_matches_reference(name, dt, jdt):
    """Held to op.tolerance(dtype) (the parity contract across frameworks)."""
    rspec, tspec = ops_pair(name)
    shape = (9, 11, 13)
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, jdt,
                                               seed=2)
    want = rir.make_sweep(rspec)(rstate[0], rstate[1],
                                 *rir.split_coeffs(rspec, rcoeffs))
    got = tir.make_sweep(tspec)(state[0], state[1],
                                *tir.split_coeffs(tspec, coeffs))
    assert got.dtype == state[0].dtype
    assert_within(got, want, tspec.tolerance(dt))


@pytest.mark.parametrize("name", list(rst.SPECS))
def test_naive_matches_reference(name):
    rspec, tspec = ops_pair(name)
    shape = (9, 12, 10) if rspec.radius == 1 else (11, 13, 12)
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, seed=5)
    want = rops.naive(rspec, rstate, rcoeffs, 3)
    got = tops.naive(tspec, state, coeffs, 3)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))


# ---------------------------------------------------------------------------
# Operator registry
# ---------------------------------------------------------------------------

def test_resolve_op_and_register():
    assert tir.resolve_op("7pt-var") is tir.OPS["7pt-var"]
    op = tir.StencilOp("torch-test-op",
                       (tir.Tap(0, 0, 0, tir.const(0)),
                        tir.Tap(0, 0, 1, tir.const(1)),
                        tir.Tap(0, 0, -1, tir.const(1))))
    assert tir.resolve_op(op) is op
    with pytest.raises(KeyError):
        tir.resolve_op("torch-test-op")
    assert tir.register(op) is op
    assert tir.resolve_op("torch-test-op") is op
    assert "torch-test-op" in tir.available()
    assert tir.register(op) is op                 # re-registering is a no-op
    with pytest.raises(ValueError, match="shadows"):
        tir.register(tir.StencilOp("7pt-var", op.taps))
    same = tir.StencilOp("7pt-const", tir.OPS["7pt-const"].taps)
    tir.register(same)
    assert tir.resolve_op("7pt-const") is tir.OPS["7pt-const"]
    with pytest.raises(TypeError):
        tir.register("7pt-var")
    got = tir.resolve_op("repro_torch.core.stencils:SPEC_25V")
    assert got is tst.SPEC_25V


# ---------------------------------------------------------------------------
# Schedule tables
# ---------------------------------------------------------------------------

TABLES = ("t_base", "parity", "w0", "y0", "y1", "active")


@pytest.mark.parametrize("r", [1, 2, 4])
def test_compiled_schedule_tables_equal_reference(r):
    for k, n_steps, ny in itertools.product((1, 2, 4), (0, 1, 3, 7, 12),
                                            (5, 9, 17, 33)):
        d_w = 2 * r * k
        if ny <= 2 * r:
            continue
        args = (d_w, r, n_steps, r, ny - r)
        want = rtil.compile_schedule(rtil.make_diamond_schedule(*args))
        got = ttil.compile_schedule(ttil.make_diamond_schedule(*args))
        for f in ("n_rows", "n_tiles", "cols", "order", "t_steps",
                  "n_active"):
            assert getattr(got, f) == getattr(want, f), (f, args)
        for f in TABLES:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f), err_msg=f)


def test_wavefront_plan_and_domain_schedule_equal_reference():
    for d_w, r, n_f in ((8, 1, 2), (8, 4, 4), (12, 3, 3)):
        a = rtil.WavefrontPlan(d_w, r, n_f, d_w // (2 * r))
        b = ttil.WavefrontPlan(d_w, r, n_f, d_w // (2 * r))
        assert a.z_working_set == b.z_working_set
        assert (rtil.wavefront_width(d_w, r, n_f)
                == ttil.wavefront_width(d_w, r, n_f))
    want = rtil.make_diamond_schedule(8, 1, 9, 0, 30)
    got = ttil.make_diamond_schedule(8, 1, 9, 0, 30)
    assert [[t.spans for t in row] for row in got.rows] == \
        [[t.spans for t in row] for row in want.rows]
