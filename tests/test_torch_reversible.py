"""The port's reversible backward for 2nd-order advances, and what each
residual policy saves.

The leapfrog recurrence ``U_t = 2·U_{t-1} - U_{t-2} + s·L(U_{t-1})``
inverts by running the same forward advance on the swapped state,
``U_{t-2} = mwd_run(op, (U_{t-1}, U_t), 1)[0]``; `kernels.adjoint` keeps
only the two output levels of a 2nd-order advance and reconstructs the
earlier states on the way back. This suite holds, in the port (K1's plain
version on the CPU):

1. the reconstruction walking all N steps back within the per-op absolute
   budgets of the reference's tests/test_reversible.py (constants copied;
   the interior only, since the entry frame sync overwrites prev's frame),
   and above a tenth of them, so the budgets are no looser here;
2. what the forward saves for the backward (counted by
   `torch.autograd.graph.saved_tensors_hooks`): the same bytes at N=8 and
   N=64 for 2nd order, growing with N for 1st-order variable coefficients,
   the coefficient streams alone where they need no gradient, and nothing
   for 1st-order constant coefficients;
3. gradients through 8 reconstructed steps against autograd through the
   un-blocked sweep, to the reference's relative 5e-4.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_mwd as tkern

_MIXED = tir.StencilOp(
    "rev-mixed",
    (tir.Tap(0, 0, 0, tir.const(1)),
     tir.Tap(-1, 0, 0, tir.array(0)), tir.Tap(1, 0, 0, tir.array(0)),
     tir.Tap(0, -1, 0, tir.array(1)), tir.Tap(0, 1, 0, tir.array(1)),
     tir.Tap(0, 0, -1, tir.const(2)), tir.Tap(0, 0, 1, tir.const(2))),
    time_order=2, scale=tir.const(0),
    default_scalars=(0.21, -0.53, 0.11), coeff_scale=0.08)

_ALL = dict(tst.SPECS, **{_MIXED.name: _MIXED})

# (grid, n_steps, interior abs budget @ f32): the reference's
# tests/test_reversible.py values, calibrated there at about 4x the worst
# reconstruction error over seeds 0-2
_REVERSIBLE = {
    "25pt-const": ((16, 20, 16), 8, 2e-4),
    "rev-mixed": ((6, 8, 8), 16, 3e-5),
}


def _setup(op, grid, seed):
    state, coeffs = tst.make_problem(op, grid, seed=seed, device="cpu")
    arrays, scalars = tir.split_coeffs(op, coeffs)
    return state, arrays, scalars


@functools.lru_cache(maxsize=None)
def _recon_worst(name: str, seed: int) -> float:
    """Worst interior reconstruction error walking all N steps back."""
    op = _ALL[name]
    grid, n, _ = _REVERSIBLE[name]
    r = op.radius
    state, arrays, scalars = _setup(op, grid, seed)
    d_w = 8 if r > 1 else 4

    def run(pair, k):
        return tkern.mwd_run(op, pair, arrays, scalars, k, d_w=d_w, n_f=2)

    states = [tuple(state)]
    for _ in range(n):
        states.append(run(states[-1], 1))
    core = lambda a: a[r:-r, r:-r, r:-r]
    u, v = states[-1]
    worst = 0.0
    for t in range(n, 0, -1):
        u_back = run((v, u), 1)[0]          # U_{t-2} from (U_t, U_{t-1})
        worst = max(
            worst,
            float((core(v) - core(states[t - 1][0])).abs().max()),
            float((core(u_back) - core(states[t - 1][1])).abs().max()))
        u, v = v, u_back
    return worst


@pytest.mark.parametrize("name", list(_REVERSIBLE))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconstruction_within_budget(name, seed):
    _, n, budget = _REVERSIBLE[name]
    err = _recon_worst(name, seed)
    assert 0 < err <= budget, (
        f"{name}: forward-{n}-backward-{n} reconstruction err {err:.3e} "
        f"exceeds budget {budget:.1e}")


@pytest.mark.parametrize("name", list(_REVERSIBLE))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reconstruction_budget_is_tight(name, seed):
    """A 10x-tightened budget fails: the copied budgets fit the port too."""
    _, _, budget = _REVERSIBLE[name]
    err = _recon_worst(name, seed)
    assert err > budget / 10, (
        f"{name}: err {err:.3e} passes even a 10x-tightened budget "
        f"{budget / 10:.1e}")


def _saved_bytes(name, n, need_arrays=True):
    """Bytes the forward of `mwd_diff` saves for its backward pass."""
    op = _ALL[name]
    grid = (6, 8, 8) if op.radius == 1 else (16, 20, 16)
    state, arrays, scalars = _setup(op, grid, seed=0)
    cur = state[0].clone().requires_grad_()
    if arrays is not None and need_arrays:
        arrays = arrays.clone().requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        out = tops.mwd_diff(op, (cur, state[1]),
                            tir.join_coeffs(op, arrays, scalars), n,
                            d_w=8 if op.radius > 1 else 4)
    assert out[0].grad_fn is not None
    return sum(t.numel() * t.element_size() for t in saved)


@pytest.mark.parametrize("name", ["rev-mixed", "25pt-const"])
def test_residual_memory_flat_in_step_count_second_order(name):
    """2nd order saves the two output levels and the streams, whatever N."""
    b8, b64 = _saved_bytes(name, 8), _saved_bytes(name, 64)
    op = _ALL[name]
    grid = (6, 8, 8) if op.radius == 1 else (16, 20, 16)
    cells = int(np.prod(grid))
    assert b8 == b64 == (2 + op.n_coeff_arrays) * cells * 4


def test_residual_memory_grows_for_first_order_var_coeff():
    """1st order with variable coefficients stacks the per-step inputs."""
    b8, b64 = _saved_bytes("7pt-var", 8), _saved_bytes("7pt-var", 64)
    assert b64 > 3 * b8, (b8, b64)
    cells = 6 * 8 * 8
    assert b8 == (8 + 7) * cells * 4         # 8 states, 7 streams
    # no stream gradient wanted: the streams alone, for the adjoint
    assert _saved_bytes("7pt-var", 64, need_arrays=False) == 7 * cells * 4


def test_first_order_const_coeff_saves_nothing():
    assert _saved_bytes("7pt-const", 8) == 0
    assert _saved_bytes("7pt-const", 64) == 0


def test_long_horizon_gradients_stay_accurate():
    """Gradients through 8 reconstructed steps match the un-blocked sweep."""
    op = tst.SPECS["25pt-const"]
    grid, n = (16, 20, 16), 8
    state, arrays, scalars = _setup(op, grid, seed=0)
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        grid).astype(np.float32))

    def grads(runner):
        args = [t.clone().requires_grad_()
                for t in (state[0], state[1], arrays)]
        out = runner(op, (args[0], args[1]),
                     tir.join_coeffs(op, args[2], scalars), n)
        return torch.autograd.grad((w * out[0]).sum(), args)

    got = grads(lambda o, s, c, k: tops.mwd_diff(o, s, c, k))
    want = grads(lambda o, s, c, k: tst.run_naive(o, s, c, k))
    for nm, a, b in zip(("cur", "prev", "arrays"), got, want):
        err = float((a - b).abs().max())
        mag = max(float(b.abs().max()), 1.0)
        assert err / mag < 5e-4, f"{nm}: rel err {err / mag:.3e}"
