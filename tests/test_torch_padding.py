"""The port's frozen-halo masking (`repro_torch.core.padding`) vs the reference.

Held against `repro.core.padding` on identical inputs: the masking recipe
of every kind of operator (twin names, taps, groups, scale, fingerprints,
slot sources, freezes, kept scalars), the refusal of an op whose centre
shares its group, and `pad_problem`'s tensors bitwise. Inside the port the
padded run, cropped, equals the unpadded run bitwise at f32 and f64
(``torch.equal``, which reads a frozen ``-0.0`` and ``+0.0`` as equal; see
the module docstring). Across frameworks the padded run is held to the
reference's unpadded `ops.mwd` within `op.tolerance`. At bf16 and fp16 the
promoted streams round the scalars to the stream dtype: bitwise when the
scalars are representable there (as `make_problem` makes them), within the
tolerance otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import padding as rpad
from repro.core import stencils as rst
from repro.core.mwd import MWDPlan as RPlan
from repro.kernels import ops as rops
from repro_torch.core import ir as tir
from repro_torch.core import padding as tpad
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.kernels import ops as tops

STAR = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]


def aniso11(irm):
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [irm.Tap(0, 0, 0, irm.array(0)),
            irm.Tap(-1, 0, 0, irm.array(1)), irm.Tap(1, 0, 0, irm.array(1)),
            irm.Tap(0, -1, 0, irm.array(2)), irm.Tap(0, 1, 0, irm.array(2))]
    taps += [irm.Tap(0, 0, s * d, irm.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return irm.StencilOp("aniso11", tuple(taps),
                         default_scalars=(0.08, 0.04, 0.02))


def wave_const_scale(irm):
    """2nd order with a compile-time scale: the scale is promoted."""
    taps = [irm.Tap(0, 0, 0, irm.const(0))]
    taps += [irm.Tap(*o, irm.const(1)) for o in STAR]
    return irm.StencilOp("wave-cs", tuple(taps), time_order=2,
                         scale=irm.const(2),
                         default_scalars=(-0.6, 0.1, 0.5))


def wave_no_scale(irm):
    """2nd order with no scale: every tap group is promoted."""
    taps = [irm.Tap(0, 0, 0, irm.const(0))]
    taps += [irm.Tap(*o, irm.array(0)) for o in STAR]
    return irm.StencilOp("wave-bare", tuple(taps), time_order=2,
                         default_scalars=(-0.3,))


def no_centre(irm):
    """No centre tap: a frozen-identity centre stream is synthesized."""
    taps = [irm.Tap(*o, irm.const(0)) for o in STAR[:4]]
    taps += [irm.Tap(*o, irm.array(0)) for o in STAR[4:]]
    return irm.StencilOp("no-centre", tuple(taps), default_scalars=(0.15,))


CUSTOM = {"aniso11": aniso11, "wave-cs": wave_const_scale,
          "wave-bare": wave_no_scale, "no-centre": no_centre}
NAMES = list(rst.SPECS) + list(CUSTOM)


def ops_pair(name):
    if name in CUSTOM:
        return CUSTOM[name](rir), CUSTOM[name](tir)
    return rst.SPECS[name], tst.SPECS[name]


def shapes(op):
    """A grid, its padding class, and a plan K1 accepts at the op's R."""
    if op.radius == 1:
        return (6, 10, 8), (8, 16, 8), MWDPlan(d_w=4, n_f=2)
    return (10, 18, 14), (16, 32, 16), MWDPlan(
        d_w=8 if op.radius == 4 else 12, n_f=2)


def carry(rspec, tspec, shape, dtype=jnp.float32, seed=0):
    state, coeffs = rir.make_problem(rspec, shape, dtype=dtype, seed=seed)
    np_state = tuple(np.asarray(s) for s in state)
    np_coeffs = jax.tree_util.tree_map(np.asarray, coeffs)
    return (state, coeffs), tir.problem_from_numpy(tspec, np_state, np_coeffs,
                                                   device="cpu")


def as_f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(a).astype(np.float64)


def describe(op):
    """Everything of an op that decides its kernel and its plan key."""
    return {"name": op.name, "time_order": op.time_order,
            "taps": [(t.dz, t.dy, t.dx, t.coeff.kind, t.coeff.index)
                     for t in op.taps],
            "groups": [(c.describe(), [t.offset for t in ts])
                       for c, ts in op.groups],
            "scale": op.scale.describe() if op.scale else None,
            "default_scalars": op.default_scalars,
            "fingerprint": op.fingerprint}


@pytest.mark.parametrize("name", NAMES)
def test_mask_recipe_equals_reference(name):
    rspec, tspec = ops_pair(name)
    want, got = rpad.mask_recipe(rspec), tpad.mask_recipe(tspec)
    assert describe(got.op) == describe(want.op)
    assert got.sources == want.sources
    assert got.freezes == want.freezes
    assert got.scalar_map == want.scalar_map
    assert tpad.masked_variant(tspec) is got.op       # cached per op
    pure = name in ("7pt-var", "25pt-var", "25pt-const")
    assert (got.op is tspec) == pure


def test_center_sharing_group_is_refused_like_the_reference():
    def shared(irm):
        taps = (irm.Tap(0, 0, 0, irm.const(0)), irm.Tap(0, 0, 1, irm.const(0)))
        return irm.StencilOp("shared-center", taps, default_scalars=(0.5,))
    with pytest.raises(ValueError) as want:
        rpad.masked_variant(shared(rir))
    with pytest.raises(ValueError) as got:
        tpad.masked_variant(shared(tir))
    assert str(got.value) == str(want.value)
    assert "exact padding ladder" in str(got.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_pad_problem_equals_reference_bitwise(name, dtype):
    rspec, tspec = ops_pair(name)
    shape, padded, _ = shapes(tspec)
    rdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    (rstate, rcoeffs), (tstate, tcoeffs) = carry(rspec, tspec, shape, rdt,
                                                 seed=5)
    rop, rst_p, rcf_p = rpad.pad_problem(rspec, rstate, rcoeffs, padded)
    top, tst_p, tcf_p = tpad.pad_problem(tspec, tstate, tcoeffs, padded)
    assert top.fingerprint == rop.fingerprint
    for g, w in zip(tst_p, rst_p):
        assert g.shape == tuple(padded)
        np.testing.assert_array_equal(as_f64(g), as_f64(w))
    rarr, rsc = rir.split_coeffs(rop, rcf_p)
    tarr, tsc = tir.split_coeffs(top, tcf_p)
    np.testing.assert_array_equal(as_f64(tarr), as_f64(rarr))
    assert tuple(float(x) for x in tsc) == tuple(float(x) for x in rsc)
    assert tarr.dtype == tst_p[0].dtype


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", NAMES)
def test_padded_run_bitwise_equals_unpadded(name, dtype):
    _, spec = ops_pair(name)
    shape, padded, plan = shapes(spec)
    state, coeffs = tst.make_problem(spec, shape, dtype=dtype, seed=3,
                                     device="cpu")
    for n_steps in (1, 3):
        want = tops.mwd(spec, state, coeffs, n_steps, plan=plan)
        mop, state_p, coeffs_p = tpad.pad_problem(spec, state, coeffs,
                                                  padded)
        got = tpad.crop_state(tops.mwd(mop, state_p, coeffs_p, n_steps,
                                       plan=plan), shape)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_padded_run_agrees_with_reference_unpadded(name):
    rspec, tspec = ops_pair(name)
    shape, padded, plan = shapes(tspec)
    (rstate, rcoeffs), (tstate, tcoeffs) = carry(rspec, tspec, shape, seed=7)
    want = rops.mwd(rspec, rstate, rcoeffs, 2,
                    plan=RPlan(d_w=plan.d_w, n_f=plan.n_f))
    mop, state_p, coeffs_p = tpad.pad_problem(tspec, tstate, tcoeffs, padded)
    got = tpad.crop_state(tops.mwd(mop, state_p, coeffs_p, 2, plan=plan),
                          shape)
    atol, rtol = tspec.tolerance("f32")
    for g, w in zip(got, want):
        w = np.asarray(w).astype(np.float64)
        assert np.all(np.abs(as_f64(g) - w) <= atol + rtol * np.abs(w))


@pytest.mark.parametrize("acc", ["auto", "native"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_reduced_precision_scalar_op_as_found(dtype, acc):
    """7pt-const's twin holds each scalar as a stream in the stream dtype.
    With make_problem's scalars (already rounded to it) the padded run is
    bitwise; with scalars the dtype cannot hold (0.4, 0.1) the stream
    rounds them while the unpadded kernel multiplies by ``(float)scalar``,
    so the two differ, within the op's tolerance."""
    spec = tst.SPECS["7pt-const"]
    shape, padded, plan = shapes(spec)
    state, coeffs = tst.make_problem(spec, shape, dtype=dtype, seed=3,
                                     device="cpu")
    for scalars, bitwise in ((coeffs, True), ((0.4, 0.1), False)):
        want = tops.mwd(spec, state, scalars, 2, plan=plan, acc=acc)
        mop, state_p, coeffs_p = tpad.pad_problem(spec, state, scalars,
                                                  padded)
        got = tpad.crop_state(tops.mwd(mop, state_p, coeffs_p, 2, plan=plan,
                                       acc=acc), shape)
        assert all(torch.equal(g, w) for g, w in zip(got, want)) == bitwise
        atol, rtol = spec.tolerance(dtype)
        for g, w in zip(got, want):
            assert np.all(np.abs(as_f64(g) - as_f64(w))
                          <= atol + rtol * np.abs(as_f64(w)))


def test_padded_shape_must_dominate_the_grid():
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    with pytest.raises(ValueError, match="dominate"):
        tpad.pad_problem(spec, state, coeffs, (6, 8, 8))
    with pytest.raises(ValueError, match="dominate"):
        tpad.pad_batch(spec, [state, state], [coeffs, coeffs], (6, 16, 4))


@pytest.mark.parametrize("name", ["7pt-const", "25pt-const", "aniso11"])
def test_pad_batch_members_equal_pad_problem(name):
    """The stacked build writes each member as `pad_problem` would."""
    _, spec = ops_pair(name)
    shape, padded, _ = shapes(spec)
    other = (shape[0] + 1, shape[1] + 1, shape[2])
    probs = [tst.make_problem(spec, sh, seed=s, device="cpu")
             for s, sh in enumerate((shape, other, padded))]
    mop, (cur_b, prev_b), packed = tpad.pad_batch(
        spec, [p[0] for p in probs], [p[1] for p in probs], padded)
    arrays_b, scalars_b = tir.split_coeffs(mop, packed)
    assert arrays_b.shape == (3, mop.n_coeff_arrays) + padded
    for i, (state, coeffs) in enumerate(probs):
        _, (cur, prev), one = tpad.pad_problem(spec, state, coeffs, padded)
        arrays, scalars = tir.split_coeffs(mop, one)
        assert torch.equal(cur_b[i], cur) and torch.equal(prev_b[i], prev)
        assert torch.equal(arrays_b[i], arrays) and scalars_b == scalars


def test_ragged_batch_must_share_scalars():
    spec = tst.SPECS["7pt-const"]
    s1, c1 = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    s2, _ = tst.make_problem(spec, (6, 12, 8), seed=1, device="cpu")
    with pytest.raises(ValueError, match="share scalar"):
        tpad.pad_batch(spec, [s1, s2], [c1, (0.9, 0.2)], (8, 16, 8))


def test_mwd_batched_takes_stacked_streams_without_a_copy():
    spec = tst.SPECS["7pt-var"]
    probs = [tst.make_problem(spec, (6, 10, 8), seed=s, device="cpu")
             for s in (1, 2)]
    plan = MWDPlan(d_w=4, n_f=2)
    want = tops.mwd_batched(spec, [p[0] for p in probs],
                            [p[1] for p in probs], 2, plan=plan)
    stacked = tuple(torch.stack([p[0][i] for p in probs]) for i in (0, 1))
    streams = torch.stack([p[1] for p in probs])
    got = tops.mwd_batched(spec, stacked, streams, 2, plan=plan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="stacked for 3"):
        tops.mwd_batched(spec, stacked, torch.cat([streams, streams[:1]]), 2,
                         plan=plan)
