"""MWD plans and the span-update oracles of the MWD kernel.

The port of `repro.core.mwd`. `run_mwd` walks the diamond tessellation tile
by tile and `run_compiled` walks the compiled schedule tables in row-major
order; both update each span in place with the two-buffer parity scheme
(the value of cell y at time t lives in ``bufs[t % 2]``). They are the CPU
oracles of the CUDA kernel in `repro_torch.kernels.stencil_mwd`. The
z-wavefront is a locality device, not a semantic one, so these oracles
update the full z extent per span.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import ir
from repro_torch.core import stencils as st
from repro_torch.core import tiling


@dataclasses.dataclass(frozen=True)
class MWDPlan:
    """Tunable parameters of one MWD configuration (same fields as the reference)."""

    d_w: int = 8          # diamond width along y (multiple of 2R)
    n_f: int = 1          # wavefront slab thickness along z
    t_block: int = 0      # fused time steps for the ghost-zone kernel (0=off)
    tg_x: int = 1         # devices sharing a tile along x
    block_x: int = 0      # 0 = never tile x (paper's leading-dimension rule)
    fused: bool = True    # whole schedule at once vs fresh grids per row

    def wavefront(self, radius: int) -> tiling.WavefrontPlan:
        """Wavefront geometry of this plan for stencil radius `radius`."""
        t_b = self.d_w // (2 * radius)
        return tiling.WavefrontPlan(d_w=self.d_w, radius=radius,
                                    n_f=self.n_f, t_block=t_b)


def sync_dirichlet_frame(cur, prev, r: int):
    """Copy cur's boundary frame into a copy of prev (all levels share it).

    Works on the trailing (z, y, x) axes, so a leading batch axis passes
    through. The caller's `prev` is left untouched.
    """
    prev = prev.clone()
    for ax in range(3):
        lo = (...,) + tuple(slice(None) if a != ax else slice(0, r)
                            for a in range(3))
        hi = (...,) + tuple(slice(None) if a != ax else slice(-r, None)
                            for a in range(3))
        prev[lo] = cur[lo]
        prev[hi] = cur[hi]
    return prev


def _span_update(spec: st.StencilSpec, bufs, arrays, scalars, y0: int,
                 y1: int, t_parity: int) -> None:
    """Advance rows [y0, y1) from level parity `t_parity`, in place.

    The written buffer doubles as the t-1 level a 2nd-order sweep reads.
    """
    r = spec.radius
    cur, dst = bufs[t_parity], bufs[1 - t_parity]
    nz, _, nx = cur.shape
    dst[r:nz - r, y0:y1, r:nx - r] = ir.sweep_region(
        spec, cur, dst, arrays, scalars, (r, y0, r), (nz - r, y1, nx - r))


def _start(spec, state, coeffs):
    cur, prev = state
    prev = sync_dirichlet_frame(cur, prev, spec.radius)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    scalars = tuple(float(x) for x in scalars)
    # bufs[p] holds the levels of parity p: t=0 is even, prev is t=-1
    return [cur.clone(), prev], arrays, scalars


def run_mwd(spec: st.StencilSpec, state, coeffs, n_steps: int,
            plan: MWDPlan):
    """Advance `n_steps` via the diamond schedule; returns (cur, prev)."""
    ny = state[0].shape[1]
    r = spec.radius
    bufs, arrays, scalars = _start(spec, state, coeffs)
    sched = tiling.make_diamond_schedule(plan.d_w, r, n_steps,
                                         y_lo=r, y_hi=ny - r)
    for row in sched.rows:
        for tile in row:
            for (t, y0, y1) in tile.spans:
                _span_update(spec, bufs, arrays, scalars, y0, y1, t % 2)
    p = n_steps % 2
    return bufs[p], bufs[1 - p]


def run_compiled(spec: st.StencilSpec, state, coeffs, n_steps: int,
                 plan: MWDPlan):
    """Oracle over the compiled schedule tables, in row-major launch order."""
    ny = state[0].shape[1]
    r = spec.radius
    bufs, arrays, scalars = _start(spec, state, coeffs)
    comp = tiling.compile_schedule(
        tiling.make_diamond_schedule(plan.d_w, r, n_steps, r, ny - r))
    for i in range(comp.n_rows):
        p0 = int(comp.parity[i])
        for k in range(comp.n_tiles):
            if not comp.active[i, k]:
                continue
            for tau in range(comp.t_steps):
                y0, y1 = int(comp.y0[i, k, tau]), int(comp.y1[i, k, tau])
                if y1 > y0:
                    _span_update(spec, bufs, arrays, scalars, y0, y1,
                                 (p0 + tau) % 2)
    p = n_steps % 2
    return bufs[p], bufs[1 - p]


def run_naive(spec: st.StencilSpec, state, coeffs, n_steps: int):
    """Reference: n_steps sequential naive sweeps (re-export for symmetry)."""
    return st.run_naive(spec, state, coeffs, n_steps)
