"""Stencil operators as IR instances + the sweep/step/problem API.

Grid layout is (z, y, x) with x contiguous. A sweep advances one time step
on the interior [R:-R] of every axis; the boundary frame is Dirichlet.
State is ``(cur, prev)`` and a step maps it to ``(new, cur)``.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.core import ir
from repro_torch.core.ir import StencilOp

StencilSpec = StencilOp

SPEC_7C = ir.OPS["7pt-const"]
SPEC_7V = ir.OPS["7pt-var"]
SPEC_25C = ir.OPS["25pt-const"]
SPEC_25V = ir.OPS["25pt-var"]

SPECS = {s.name: s for s in (SPEC_7C, SPEC_7V, SPEC_25C, SPEC_25V)}


def sweep_fn(spec: StencilOp) -> Callable:
    """The ``(cur, prev, coeffs) -> new`` sweep of `spec` (packed coeffs)."""
    gen = ir.make_sweep(spec)

    def sweep(cur, prev, coeffs):
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        return gen(cur, prev, arrays, scalars)

    return sweep


def step(spec: StencilOp, state, coeffs):
    """One time step with pointer swap: (cur, prev) -> (new, cur)."""
    cur, prev = state
    new = sweep_fn(spec)(cur, prev, coeffs)
    return (new, cur)


def run_naive(spec: StencilOp, state, coeffs, n_steps: int):
    """Reference: n_steps sequential full-grid sweeps (paper Fig. 1a)."""
    for _ in range(n_steps):
        state = step(spec, state, coeffs)
    return state


def make_problem(spec: StencilOp, shape, dtype=None, seed: int = 0,
                 device="cuda"):
    """Random initial state + coefficients for `spec` on grid `shape`."""
    return ir.make_problem(spec, shape, dtype=dtype, seed=seed, device=device)


def random_problem(spec: StencilOp, shape, dtype=None, seed: int = 0,
                   device="cuda"):
    """`make_problem`'s distribution drawn on the device (`ir.random_problem`):
    not the reference's numbers, for timing at production sizes."""
    return ir.random_problem(spec, shape, dtype=dtype, seed=seed,
                             device=device)

