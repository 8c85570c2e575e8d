"""The port's differentiable MWD path against the JAX reference's.

`repro_torch.kernels.adjoint.mwd_diff` (a `torch.autograd.Function` whose
backward runs K1 on the adjoint operator; on CPU tensors K1's plain
version) is held against three oracles:

1. `jax.grad` of the reference's `repro.kernels.adjoint.mwd_diff` (its
   Pallas kernel in interpret mode, as its own tests run it), on the same
   numpy-made inputs, within the reference's gradcheck tolerance
   ``8·(atol + rtol·max(|ref|, 1))`` of `op.tolerance("f32")`;
2. `torch.autograd` through the port's un-blocked `stencils.run_naive`;
3. central finite differences in float64.

The adjoint's structure and fingerprints, `map_coeffs`, `_frame_shell` and
`_coeff_grads` are held against the reference's helpers; the port's own
invariants (the primal equals `ops.mwd` bitwise, batched equals a per-item
loop bitwise) are held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import stencils as rst
from repro.kernels import adjoint as radj
from repro_torch.core import ir as tir
from repro_torch.core import registry as treg
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.kernels import adjoint as tadj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_mwd as tkern


def mixed(irmod):
    """The reference adjoint test's op: const + array taps in one 2nd-order
    operator with a const time-recurrence scale."""
    return irmod.StencilOp(
        "adj-mixed",
        (irmod.Tap(0, 0, 0, irmod.const(1)),
         irmod.Tap(-1, 0, 0, irmod.array(0)),
         irmod.Tap(1, 0, 0, irmod.array(0)),
         irmod.Tap(0, -1, 0, irmod.array(1)),
         irmod.Tap(0, 1, 0, irmod.array(1)),
         irmod.Tap(0, 0, -1, irmod.const(2)),
         irmod.Tap(0, 0, 1, irmod.const(2))),
        time_order=2, scale=irmod.const(0),
        default_scalars=(0.21, -0.53, 0.11), coeff_scale=0.08)


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


PAPER = list(rst.SPECS)
CUSTOM = {"adj-mixed": mixed, "aniso11": aniso11}


def ops_pair(name):
    if name in CUSTOM:
        return CUSTOM[name](rir), CUSTOM[name](tir)
    return rst.SPECS[name], tst.SPECS[name]


def bench_shape(op):
    """The shapes of the reference's adjoint gate (benchmarks/run.py):
    (8, 12, 10) with d_w 4 at R = 1, (14, 20, 16) with d_w 8 otherwise."""
    return ((8, 12, 10), 4) if op.radius == 1 else ((14, 20, 16), 8)


def problem(rop, grid, seed, dtype=jnp.float32):
    """The reference's problem as numpy: (cur, prev), arrays or None,
    scalars."""
    state, coeffs = rir.make_problem(rop, grid, dtype=dtype, seed=seed)
    arrays, scalars = rir.split_coeffs(rop, coeffs)
    return ((np.array(state[0]), np.array(state[1])),
            None if arrays is None else np.array(arrays),
            tuple(float(x) for x in scalars))


def leaves(state, arrays):
    """Torch leaf tensors (requiring grad) of a numpy problem."""
    ts = [torch.from_numpy(np.array(a)).requires_grad_()
          for a in state + (() if arrays is None else (arrays,))]
    return ts[0], ts[1], ts[2] if arrays is not None else None


def tol(op, mag):
    atol, rtol = op.tolerance("f32")
    return 8.0 * (atol + rtol * max(mag, 1.0))


def weights(grid, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(grid).astype(np.float32),
            rng.standard_normal(grid).astype(np.float32))


def torch_grads(top, cur, prev, arrays, scalars, n_steps, w, w2, runner,
                **kw):
    """Gradients of ``<w, out0> + <w2, out1>`` through `runner` wrt cur,
    prev and the streams (those that exist)."""
    coeffs = tir.join_coeffs(top, arrays, scalars)
    out = runner(top, (cur, prev), coeffs, n_steps, **kw)
    loss = ((torch.as_tensor(w) * out[0]).sum()
            + (torch.as_tensor(w2) * out[1]).sum())
    ins = [cur, prev] + ([arrays] if arrays is not None else [])
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    # a 1st-order advance never reads prev: zeros, as jax.grad gives
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, ins)]


def assert_close(op, got, want, what):
    for name, a, b in zip(("cur", "prev", "arrays"), got, want):
        b = np.asarray(b, np.float64)
        err = float(np.max(np.abs(a.detach().double().numpy() - b)))
        mag = float(np.max(np.abs(b)))
        assert err <= tol(op, mag), f"{what}/{name}: err {err:.3e}, |ref| {mag:.3e}"


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER + list(CUSTOM))
def test_adjoint_structure_equals_reference(name):
    rop, top = ops_pair(name)
    ra, ta = rir.adjoint(rop), tir.adjoint(top)
    assert ta is top.adjoint() and ta is tir.adjoint(top)      # cached
    assert ta.op.name == ra.op.name == f"{name}.T"
    assert ta.op.fingerprint == ra.op.fingerprint
    assert ([(t.offset, t.coeff.describe()) for t in ta.op.taps]
            == [(t.offset, t.coeff.describe()) for t in ra.op.taps])
    assert ta.op.time_order == ra.op.time_order
    assert ((ta.op.scale and ta.op.scale.describe())
            == (ra.op.scale and ra.op.scale.describe()))
    assert ([(s.shift, s.arrays, s.scalars) for s in ta.slots]
            == [(s.shift, s.arrays, s.scalars) for s in ra.slots])
    assert ta.keep_scalars == ra.keep_scalars


def test_adjoint_shapes_new_to_k1():
    """25pt-const.T: 25 array groups (past K1's largest hoist of 16), 2nd
    order with no scale; 25pt-var.T: 25 streams from 13."""
    c, v = (tir.adjoint(tst.SPECS[n]).op for n in ("25pt-const", "25pt-var"))
    assert (c.time_order, c.scale, c.n_coeff_arrays, len(c.groups)) == (
        2, None, 25, 25)
    assert (v.n_coeff_arrays, len(v.groups)) == (25, 25)
    const = tir.adjoint(tst.SPECS["7pt-const"])
    assert not const.slots and const.keep_scalars       # self-adjoint
    taps = lambda op: sorted((t.offset, t.coeff) for t in op.taps)
    assert taps(const.op) == taps(tst.SPECS["7pt-const"])


@pytest.mark.parametrize("name", PAPER + list(CUSTOM))
@pytest.mark.parametrize("batch", [False, True])
def test_map_coeffs_equals_reference(name, batch):
    rop, top = ops_pair(name)
    grid = (6, 8, 8) if rop.radius == 1 else (10, 11, 12)
    _, arrays, scalars = problem(rop, grid, seed=4)
    if arrays is not None and batch:
        arrays = np.stack([arrays, 2 * arrays])
    want, wsc = rir.adjoint(rop).map_coeffs(
        None if arrays is None else jnp.asarray(arrays), scalars)
    got, gsc = tir.adjoint(top).map_coeffs(
        None if arrays is None else torch.from_numpy(arrays), scalars)
    assert gsc == wsc
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", PAPER + list(CUSTOM))
def test_frame_shell_equals_reference_and_full_application(name):
    rop, top = ops_pair(name)
    grid = (8, 12, 10) if rop.radius == 1 else (12, 18, 14)
    _, arrays, scalars = problem(rop, grid, seed=9)
    radj_arr, radj_sc = rir.adjoint(rop).map_coeffs(
        None if arrays is None else jnp.asarray(arrays), scalars)
    ta = tir.adjoint(top)
    tadj_arr, tadj_sc = ta.map_coeffs(
        None if arrays is None else torch.from_numpy(arrays), scalars)
    g = np.random.default_rng(17).standard_normal(grid).astype(np.float32)
    want = radj._frame_shell(rir.adjoint(rop), radj_arr, radj_sc,
                             jnp.asarray(g))
    got = tadj._frame_shell(ta, tadj_arr, tadj_sc, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    full = tadj._tap_apply_full(ta, tadj_arr, tadj_sc, torch.from_numpy(g))
    np.testing.assert_allclose(
        got.numpy(), tadj._frame_only(full, top.radius).numpy(), rtol=1e-5,
        atol=1e-5)
    # the in-place form adds to the bit what the volume form returns
    base = torch.from_numpy(np.random.default_rng(3).standard_normal(
        grid).astype(np.float32))
    into = tadj._frame_shell(ta, tadj_arr, tadj_sc, torch.from_numpy(g),
                             out=base.clone())
    assert torch.equal(into, base + got)


@pytest.mark.parametrize("name", PAPER + list(CUSTOM))
def test_coeff_grads_equal_reference(name):
    rop, top = ops_pair(name)
    grid = (8, 12, 10) if rop.radius == 1 else (12, 24, 18)
    state, arrays, scalars = problem(rop, grid, seed=2)
    rng = np.random.default_rng(5)
    ghat = rng.standard_normal(grid).astype(np.float32)
    r = rop.radius
    ghat_r = radj._zero_frame(jnp.asarray(ghat), r)
    ghat_t = tadj._zero_frame(torch.from_numpy(ghat), r)
    assert np.array_equal(ghat_t.numpy(), np.asarray(ghat_r))
    want = radj._coeff_grads(rop, jnp.asarray(state[0]), ghat_r,
                             None if arrays is None else jnp.asarray(arrays),
                             scalars)
    got = tadj._coeff_grads(top, torch.from_numpy(state[0]), ghat_t,
                            None if arrays is None
                            else torch.from_numpy(arrays), scalars)
    if arrays is None:
        assert got is None and want is None
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # accumulating into a buffer adds this step's gradient to the bit
    acc = torch.from_numpy(rng.standard_normal(arrays.shape).astype(
        np.float32))
    summed = tadj._coeff_grads(top, torch.from_numpy(state[0]), ghat_t,
                               torch.from_numpy(arrays), scalars,
                               out=acc.clone())
    assert torch.equal(summed, acc + got)


# ---------------------------------------------------------------------------
# gradients against the reference's jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER + ["adj-mixed"])
def test_gradients_match_reference_jax_grad(name):
    """The shapes of the reference's gate: 2 steps, n_f 2, d_w 4 or 8."""
    rop, top = ops_pair(name)
    grid, d_w = bench_shape(rop)
    state, arrays, scalars = problem(rop, grid, seed=0)
    w, w2 = weights(grid, 13)

    def ref_loss(c, p, a):
        out = radj.mwd_diff(rop, (c, p), rir.join_coeffs(rop, a, scalars), 2,
                            d_w=d_w, n_f=2)
        return jnp.sum(w * out[0]) + jnp.sum(w2 * out[1])

    argnums = (0, 1, 2) if arrays is not None else (0, 1)
    want = jax.grad(ref_loss, argnums=argnums)(
        jnp.asarray(state[0]), jnp.asarray(state[1]),
        None if arrays is None else jnp.asarray(arrays))
    cur, prev, arr = leaves(state, arrays)
    got = torch_grads(top, cur, prev, arr, scalars, 2, w, w2, tops.mwd_diff,
                      d_w=d_w, n_f=2)
    assert_close(rop, got, want, f"{name} vs jax.grad")
    # the primal is the forward launch's result, bitwise
    coeffs = tir.join_coeffs(top, arr, scalars)
    with torch.no_grad():
        fwd = tops.mwd(top, (cur, prev), coeffs, 2, d_w=d_w, n_f=2)
        diff = tops.mwd_diff(top, (cur, prev), coeffs, 2, d_w=d_w, n_f=2)
    for a, b in zip(fwd, diff):
        assert torch.equal(a, b)


def plans(r):
    """Launch arguments by radius: the default width, a narrow one at n_f
    1, the per-row mode, an explicit `MWDPlan`."""
    d = 2 * r
    return [dict(d_w=2 * d), dict(d_w=d, n_f=1), dict(d_w=2 * d,
                                                      fused=False),
            dict(plan=MWDPlan(d_w=2 * d, n_f=4 if r == 1 else 2))]


@pytest.mark.parametrize("name", PAPER + list(CUSTOM))
@pytest.mark.parametrize("which", range(4))
def test_gradients_match_autograd_through_naive(name, which):
    _, top = ops_pair(name)
    r = top.radius
    kw = plans(r)[which]
    n_steps = 2 + which % 2
    grid = (8, 12, 10) if r == 1 else (14, 20, 16)
    state, coeffs = tst.make_problem(top, grid, seed=1, device="cpu")
    arrays, scalars = tir.split_coeffs(top, coeffs)
    w, w2 = weights(grid, 21)

    def fresh():
        return leaves((state[0].numpy(), state[1].numpy()),
                      None if arrays is None else arrays.numpy())

    got = torch_grads(top, *fresh(), scalars, n_steps, w, w2, tops.mwd_diff,
                      **kw)
    want = torch_grads(top, *fresh(), scalars, n_steps, w, w2,
                       lambda o, s, c, n: tst.run_naive(o, s, c, n))
    assert_close(top, got, [x.numpy() for x in want],
                 f"{name} {kw} vs autograd through run_naive")


@pytest.mark.parametrize("name", ["7pt-var", "adj-mixed", "25pt-const"])
def test_gradients_match_central_differences_f64(name):
    _, top = ops_pair(name)
    grid = (6, 8, 8) if top.radius == 1 else (12, 16, 12)
    d_w = 8
    n_steps, eps = 2, 1e-5
    state, coeffs = tst.make_problem(top, grid, dtype="f64", seed=5,
                                     device="cpu")
    arrays, scalars = tir.split_coeffs(top, coeffs)
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.standard_normal(grid))
    w2 = torch.from_numpy(rng.standard_normal(grid))

    def f(c, p, a):
        out = tops.mwd_diff(top, (c, p), tir.join_coeffs(top, a, scalars),
                            n_steps, d_w=d_w, n_f=2)
        return (w * out[0]).sum() + (w2 * out[1]).sum()

    args = [t.clone().requires_grad_() for t in (state[0], state[1], arrays)]
    grads = torch.autograd.grad(f(*args), args)
    dirs = [torch.from_numpy(rng.standard_normal(tuple(a.shape)))
            for a in args]
    directional = sum(float((g * d).sum()) for g, d in zip(grads, dirs))
    with torch.no_grad():
        up = f(*(a + eps * d for a, d in zip(args, dirs)))
        dn = f(*(a - eps * d for a, d in zip(args, dirs)))
    fd = (float(up) - float(dn)) / (2 * eps)
    denom = max(abs(fd), abs(directional), 1e-12)
    assert abs(directional - fd) / denom < 1e-6, (directional, fd)


# ---------------------------------------------------------------------------
# batched path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["7pt-var", "25pt-const", "adj-mixed"])
def test_batched_gradients_equal_per_item_loop(name):
    _, top = ops_pair(name)
    grid = (6, 8, 8) if top.radius == 1 else (12, 16, 12)
    b, n_steps = 3, 2
    probs = [tst.make_problem(top, grid, seed=20 + i, device="cpu")
             for i in range(b)]
    scalars = tir.split_coeffs(top, probs[0][1])[1]
    w = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (b,) + grid).astype(np.float32))

    def leaves_b():
        cur = torch.stack([p[0][0] for p in probs]).requires_grad_()
        prev = torch.stack([p[0][1] for p in probs]).requires_grad_()
        arr = torch.stack([tir.split_coeffs(top, p[1])[0]
                           for p in probs]).requires_grad_()
        return cur, prev, arr

    cur, prev, arr = leaves_b()
    coeffs = [tir.join_coeffs(top, arr[i], scalars) for i in range(b)]
    out = tops.mwd_diff_batched(top, (cur, prev), coeffs, n_steps, d_w=8)
    got = torch.autograd.grad((w * out[0]).sum(), (cur, prev, arr))
    cur, prev, arr = leaves_b()
    total = 0.0
    for i in range(b):
        o = tops.mwd_diff(top, (cur[i], prev[i]),
                          tir.join_coeffs(top, arr[i], scalars), n_steps,
                          d_w=8)
        total = total + (w[i] * o[0]).sum()
    want = torch.autograd.grad(total, (cur, prev, arr))
    for a, c in zip(got, want):
        assert torch.equal(a, c)


def test_batched_shared_coeffs_forward_and_gradient():
    """One coefficient set shared by the batch: the forward equals
    `ops.mwd_batched` bitwise and the streams' gradient is the sum of the
    per-item gradients."""
    top, grid, b = tst.SPECS["7pt-var"], (6, 8, 8), 2
    probs = [tst.make_problem(top, grid, seed=40 + i, device="cpu")
             for i in range(b)]
    states = [p[0] for p in probs]
    arrays = probs[0][1].clone().requires_grad_()
    want = tops.mwd_batched(top, states, probs[0][1], 2)
    got = tops.mwd_diff_batched(top, states, arrays, 2)
    for a, c in zip(want, got):
        assert torch.equal(a, c.detach())
    (g,) = torch.autograd.grad(got[0].sum(), [arrays])
    per_item = []
    for s in states:
        a = probs[0][1].clone().requires_grad_()
        per_item.append(torch.autograd.grad(
            tops.mwd_diff(top, s, a, 2)[0].sum(), [a])[0])
    torch.testing.assert_close(g, per_item[0] + per_item[1], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# autograd semantics, residual policy, plan resolution
# ---------------------------------------------------------------------------

def test_zero_steps_is_identity_and_never_launches():
    top = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(top, (6, 8, 8), seed=3, device="cpu")
    out = tops.mwd_diff(top, state, coeffs, 0)
    assert out[0] is state[0] and out[1] is state[1]
    outb = tops.mwd_diff_batched(top, [state, state], coeffs, 0)
    assert torch.equal(outb[0][1], state[0])


@pytest.mark.parametrize("name", ["7pt-const", "25pt-const"])
def test_unread_second_output_is_a_zero_cotangent(name):
    """A loss that reads only ``pred[0]`` (the fit's) hands the backward a
    None cotangent for the second output: the same gradients as an explicit
    zero cotangent, and as the reference's jax.grad of that loss."""
    rop, top = ops_pair(name)
    grid, d_w = bench_shape(rop)
    state, arrays, scalars = problem(rop, grid, seed=6)
    w, _ = weights(grid, 8)
    cur, prev, arr = leaves(state, arrays)
    coeffs = tir.join_coeffs(top, arr, scalars)
    out = tops.mwd_diff(top, (cur, prev), coeffs, 2, d_w=d_w)
    ins = [cur, prev] + ([arr] if arr is not None else [])
    got = torch.autograd.grad((torch.from_numpy(w) * out[0]).sum(), ins)
    zeros = np.zeros_like(w)
    cur2, prev2, arr2 = leaves(state, arrays)
    explicit = torch_grads(top, cur2, prev2, arr2, scalars, 2, w, zeros,
                           tops.mwd_diff, d_w=d_w)
    for a, c in zip(got, explicit):
        assert torch.equal(a, c)

    def ref_loss(c, p, a=None):
        o = radj.mwd_diff(rop, (c, p), rir.join_coeffs(rop, a, scalars), 2,
                          d_w=d_w)
        return jnp.sum(w * o[0])

    want = jax.grad(ref_loss, argnums=tuple(range(len(ins))))(
        *(jnp.asarray(x) for x in state + (() if arrays is None
                                             else (arrays,))))
    assert_close(rop, got, want, f"{name} pred[0] only")


def test_needs_input_grad_is_respected():
    """Streams that need no gradient get None, and the 1st-order forward
    then stacks no per-step state; an op without streams returns None for
    them."""
    top = tst.SPECS["7pt-var"]
    state, arrays = tst.make_problem(top, (6, 8, 8), seed=1, device="cpu")
    cur = state[0].clone().requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = tops.mwd_diff(top, (cur, state[1]), arrays, 4, d_w=4)
    assert len(saved) == 1                     # the streams, for the adjoint
    (g,) = torch.autograd.grad(out[0].sum(), [cur])
    assert g.shape == cur.shape
    fn = out[0].grad_fn
    assert fn.next_functions[2][0] is None     # streams: no gradient edge
    const = tst.SPECS["7pt-const"]
    s2, c2 = tst.make_problem(const, (6, 8, 8), seed=1, device="cpu")
    c = s2[0].clone().requires_grad_()
    o2 = tops.mwd_diff(const, (c, s2[1]), c2, 2, d_w=4)
    grads = o2[0].grad_fn.apply(torch.ones_like(o2[0]), None)
    assert grads[2] is None and grads[1] is None


def test_backward_runs_k1_once_per_step_on_the_adjoint_op(monkeypatch):
    """Every advance goes through `stencil_mwd.run` (K1 on CUDA tensors,
    its plain version here): the 1st-order variable-coefficient forward
    stacks its states with one 1-step advance per step, the backward runs
    one advance of the adjoint op per step."""
    calls = []

    def fake_run(job):
        calls.append(job.op.name)
        tkern.run_plain(job)
        return tkern.finish(job)

    monkeypatch.setattr(tkern, "run", fake_run)
    top = tst.SPECS["7pt-var"]
    state, arrays = tst.make_problem(top, (6, 8, 8), seed=1, device="cpu")
    arr = arrays.clone().requires_grad_()
    out = tops.mwd_diff(top, state, arr, 3, d_w=4)
    torch.autograd.grad(out[0].sum(), [arr])
    assert calls == ["7pt-var"] * 3 + ["7pt-var.T"] * 3


def test_vjp_plan_resolves_on_the_adjoint_op(tmp_path, monkeypatch):
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "plans.json"))
    top = tst.SPECS["7pt-var"]
    plan, source = tadj.resolve_adjoint_plan(top, (10, 18, 14))
    assert isinstance(plan, MWDPlan) and plan.d_w % 2 == 0
    assert source and "registry" not in source       # empty registry: model
    adj = tir.adjoint(top)
    treg.default_registry().put(adj.op, (10, 18, 14), MWDPlan(d_w=2, n_f=1),
                                9.9, variant="vjp")
    plan2, source2 = tadj.resolve_adjoint_plan(top, (10, 18, 14))
    assert plan2.d_w == 2 and source2.startswith("registry")
    key = treg.plan_key(adj.op, (10, 18, 14), variant="vjp")
    assert key.startswith("7pt-var.T@" + adj.op.fingerprint)
    assert key.endswith("|vjp")
    # the forward entry is untouched and plan="auto" takes both
    fwd, adjp = tadj._plans(top, (torch.zeros(10, 18, 14),), 8, 2, True,
                            "auto")
    assert adjp == (2, 1, True)
    assert fwd == tuple(getattr(treg.resolve_plan(top, (10, 18, 14))[0], k)
                        for k in ("d_w", "n_f", "fused"))
    # and a fit-sized mwd_diff runs through the resolved plans
    state, arrays = tst.make_problem(top, (10, 18, 14), seed=0, device="cpu")
    arr = arrays.clone().requires_grad_()
    out = tops.mwd_diff(top, state, arr, 2, plan="auto")
    (g,) = torch.autograd.grad(out[0].sum(), [arr])
    assert bool(torch.isfinite(g).all())
