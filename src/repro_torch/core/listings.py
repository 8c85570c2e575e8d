"""The paper's Listings 1-4, transcribed by hand in torch.

The port of `repro.core.listings`. Nothing dispatches them: every execution
path runs the sweep generated from the IR (`core.ir.make_sweep`). They are
independent references that pin the generator to the paper's operation
order: ``tests/test_torch_listings.py`` holds the generated sweeps bitwise
equal to them, and them to the reference's listings.

Each function keeps the reference's per-listing coefficient convention:
``sweep_7pt_const(cur, prev, (c0, c1))``, ``sweep_7pt_var(cur, prev, c7)``,
``sweep_25pt_const(cur, prev, (C, c5))``, ``sweep_25pt_var(cur, prev, c13)``,
with grids ``(z, y, x)``; the update writes the interior ``[R:-R]`` of
every axis into a copy of `cur` and carries the Dirichlet frame through.
"""

from __future__ import annotations

import torch


def _core(a: torch.Tensor, r: int) -> torch.Tensor:
    return a[r:-r, r:-r, r:-r]


def _shift(a: torch.Tensor, r: int, axis: int, off: int) -> torch.Tensor:
    """Core-sized view of `a` displaced by `off` along `axis` (|off| <= r)."""
    idx = []
    for ax in range(3):
        d = off if ax == axis else 0
        idx.append(slice(r + d, a.shape[ax] - r + d or None))
    return a[tuple(idx)]


def _with_core(cur: torch.Tensor, r: int, out_core) -> torch.Tensor:
    out = cur.clone()
    out[r:-r, r:-r, r:-r] = out_core
    return out


def sweep_7pt_const(cur, prev, coeffs):
    """Listing 1: U = c0*V + c1*(6 axis neighbors); coeffs = (c0, c1)."""
    del prev
    c0, c1 = coeffs
    r = 1
    acc = sum(_shift(cur, r, ax, o) for ax in range(3) for o in (-1, 1))
    return _with_core(cur, r, c0 * _core(cur, r) + c1 * acc)


def sweep_7pt_var(cur, prev, coeffs):
    """Listing 2: per-direction coefficient arrays, no symmetry.

    coeffs: tensor (7, Nz, Ny, Nx): [center, z-, z+, y-, y+, x-, x+].
    """
    del prev
    r = 1
    c = coeffs
    out_core = _core(c[0], r) * _core(cur, r)
    k = 1
    for ax in range(3):
        for o in (-1, 1):
            out_core = out_core + _core(c[k], r) * _shift(cur, r, ax, o)
            k += 1
    return _with_core(cur, r, out_core)


def sweep_25pt_const(cur, prev, coeffs):
    """Listing 3: 2nd-order-in-time wave equation, R=4, axis symmetry.

    coeffs = (C, c) with C a domain-sized tensor and c = (c0..c4) scalars.
    U_new = 2*V - U + C * [c0*V + sum_r c_r * (6 neighbors at distance r)].
    """
    C, c = coeffs
    r = 4
    lap = c[0] * _core(cur, r)
    for d in range(1, 5):
        acc = sum(_shift(cur, r, ax, o * d)
                  for ax in range(3) for o in (-1, 1))
        lap = lap + c[d] * acc
    out_core = 2.0 * _core(cur, r) - _core(prev, r) + _core(C, r) * lap
    return _with_core(cur, r, out_core)


def sweep_25pt_var(cur, prev, coeffs):
    """Listing 4: R=4, variable anisotropic coefficients, axis symmetry.

    coeffs: tensor (13, Nz, Ny, Nx): [center] + [axis 0..2][dist 1..4].
    """
    del prev
    r = 4
    c = coeffs
    out_core = _core(c[0], r) * _core(cur, r)
    for ax in range(3):
        for d in range(1, 5):
            w = _core(c[1 + ax * 4 + (d - 1)], r)
            out_core = out_core + w * (_shift(cur, r, ax, d) +
                                       _shift(cur, r, ax, -d))
    return _with_core(cur, r, out_core)
