"""MWD plans and the span-update oracles of the MWD kernel.

The port of `repro.core.mwd`. `run_mwd` walks the diamond tessellation tile
by tile and `run_compiled` walks the compiled schedule tables in row-major
order; both update each span in place with the two-buffer parity scheme
(the value of cell y at time t lives in ``bufs[t % 2]``). They are the CPU
oracles of the CUDA kernel in `repro_torch.kernels.stencil_mwd`. The
z-wavefront is a locality device, not a semantic one, so these oracles
update the full z extent per span.

`k1_geometry` and `barrier_schedule` are the launch geometry of the CUDA
kernel computed from shapes alone: the launcher, the machine model
(`core.models`) and the chip check all read them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

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


def traffic_per_pass(spec: st.StencilSpec, plan: MWDPlan, grid_shape,
                     word_bytes: int = 4) -> dict:
    """Modeled HBM traffic of one diamond pass over the grid (Eq. 5 terms)."""
    from repro_torch.core import models
    nz, ny, nx = grid_shape
    t_pass = plan.d_w // (2 * spec.radius)  # steps advanced per pass
    lups = nz * ny * nx * t_pass
    bc = models.code_balance(spec, plan.d_w, word_bytes)
    return {"lups": lups, "bytes": bc * lups, "code_balance": bc,
            "steps": t_pass}


@dataclasses.dataclass(frozen=True)
class K1Geometry:
    """Launch geometry of one K1 advance, from shapes alone.

    `pads` are the pad offsets ``(pz, py, px)`` of the padded parity grids,
    `bounds` the interior ``lo_z, hi_z, lo_y, hi_y, lo_x, hi_x`` in padded
    coordinates, `n_j` the wavefront steps of ``n_f`` z rows per tile.
    """

    comp: tiling.CompiledSchedule
    pads: tuple[int, int, int]
    bounds: tuple[int, ...]
    n_f: int
    n_j: int
    radius: int
    fused: bool


@functools.lru_cache(maxsize=64)
def _compiled(d_w: int, radius: int, n_steps: int, y_lo: int,
              y_hi: int) -> tiling.CompiledSchedule:
    """The compiled schedule tables, shared read-only by every plan that
    differs only in N_F, mode or grid depth (the model scores many)."""
    comp = tiling.compile_schedule(
        tiling.make_diamond_schedule(d_w, radius, n_steps, y_lo, y_hi))
    for field in dataclasses.fields(comp):
        arr = getattr(comp, field.name)
        if isinstance(arr, np.ndarray):
            arr.setflags(write=False)
    return comp


def k1_geometry(radius: int, grid_shape, d_w: int, n_f: int, n_steps: int,
                *, fused: bool = True, interior=None,
                y_domain=None) -> K1Geometry:
    """The schedule tables, padding and interior of one K1 advance.

    Raises ValueError unless ``2R | d_w`` and ``n_f | d_w`` and, when the
    schedule has rows, the interior lies inside the grid. `interior` is
    ``[lo_z, hi_z, lo_y, hi_y, lo_x, hi_x]`` in grid coordinates (default:
    the R-deep Dirichlet frame); `y_domain` the tessellation's y extent
    (default ``(R, ny - R)``).
    """
    r = radius
    if d_w % (2 * r) or d_w % n_f:
        raise ValueError(f"need 2R | d_w and n_f | d_w (d_w={d_w}, R={r}, "
                         f"n_f={n_f})")
    nz, ny, nx = grid_shape
    y_lo, y_hi = y_domain if y_domain is not None else (r, ny - r)
    comp = _compiled(d_w, r, n_steps, int(y_lo), int(y_hi))
    pz, py, px = r, 2 * d_w + r, r
    if interior is None:
        interior = (r, nz - r, r, ny - r, r, nx - r)
    interior = tuple(int(v) for v in interior)
    if comp.n_rows:
        for ax, n in enumerate((nz, ny, nx)):
            if not 0 <= interior[2 * ax] <= interior[2 * ax + 1] <= n:
                raise ValueError(f"interior {interior} leaves the grid "
                                 f"{(nz, ny, nx)}")
    return K1Geometry(
        comp=comp, pads=(pz, py, px),
        bounds=tuple(v + p for v, p in zip(interior,
                                           (pz, pz, py, py, px, px))),
        n_f=n_f, n_j=-(-(pz + nz + d_w) // n_f), radius=r, fused=fused)


def barrier_schedule(geo: K1Geometry) -> tuple[np.ndarray, np.ndarray]:
    """Which updates push x-halos, and the cluster barriers they cost.

    Returns ``(push, barriers)``: ``push[row, tile, tau]`` is the kernel's
    rule (``csrc/mwd.cu``), an update with cells pushes when a later update
    of its tile, an odd number of updates on, has cells; ``barriers[row,
    tile]`` counts the cluster barriers one CTA of that tile passes in the
    row's launch: one after every pushing update that has z rows, and one
    at the end of every step of a tile that pushes at all. At dw8 the
    25-point ops (T = 2, one update with cells) never push.
    """
    comp, (pz, py, _) = geo.comp, geo.pads
    lo_z, hi_z, lo_y, hi_y, lo_x, hi_x = geo.bounds
    cells = ((np.minimum(comp.y1 + py, hi_y) > np.maximum(comp.y0 + py, lo_y))
             & (hi_x > lo_x))                          # (row, tile, tau)
    push = np.zeros_like(cells)
    for t in range(comp.t_steps - 1):
        push[..., t] = cells[..., t] & cells[..., t + 1::2].any(-1)
    zs = (np.arange(geo.n_j)[:, None] * geo.n_f
          - (np.arange(comp.t_steps)[None, :] + 1) * geo.radius)
    z_rows = ((np.minimum(zs + geo.n_f, hi_z) > np.maximum(zs, lo_z))
              .sum(0))                                  # steps with rows
    barriers = ((push[..., :-1] * z_rows[:-1]).sum(-1)
                + geo.n_j * push.any(-1))
    if geo.fused:
        barriers = barriers * comp.active.astype(bool)
    return push, barriers


def phase_schedule(geo: K1Geometry, warps: int,
                   cells_per_row: int = 1) -> tuple[np.ndarray, ...]:
    """The barrier-ended phases one CTA of each tile passes in a row's
    launch, split by the barrier that ends them, and their rows of work.

    Returns ``(cluster, cta, work)``, each ``[row, tile]``, as K1's loop
    runs (``csrc/mwd.cu``): the barrier after the first loads (a cluster
    barrier where the launch trades halos); per wavefront step, every
    update with cells and z rows but the last (a cluster barrier where it
    pushes halos, `barrier_schedule`, else a block barrier), the step's
    last update whatever its cells (a cluster barrier where the tile
    pushes at all) and, from step ``d_w / n_f`` on, the block barrier after
    the finished slab leaves. `work` counts the rows each warp updates in
    those phases, summed: a phase of ``z`` rows by ``y`` rows takes
    ``ceil(z*y / warps)`` rows on its busiest warp, each `cells_per_row`
    passes of the lanes. Inactive tiles of a fused launch pass none.
    """
    comp, (_, py, _) = geo.comp, geo.pads
    lo_z, hi_z, lo_y, hi_y, lo_x, hi_x = geo.bounds
    push, _ = barrier_schedule(geo)
    t_steps = comp.t_steps
    y_rows = np.maximum(np.minimum(comp.y1 + py, hi_y)
                        - np.maximum(comp.y0 + py, lo_y), 0)
    y_rows = y_rows * (hi_x > lo_x)                      # (row, tile, tau)
    zs = (np.arange(geo.n_j)[:, None] * geo.n_f
          - (np.arange(t_steps)[None, :] + 1) * geo.radius)
    z_rows = np.maximum(np.minimum(zs + geo.n_f, hi_z)
                        - np.maximum(zs, lo_z), 0)        # (step, tau)
    live = (y_rows[..., None, :] > 0) & (z_rows > 0)     # (row, tile, j, tau)
    live[..., -1] = False                                 # counted apart
    pushes = push[..., None, :]
    cluster = (live & pushes).sum((-1, -2))
    cta = (live & ~pushes).sum((-1, -2))
    any_push = push.any(-1)
    exchange = bool(push.any())
    cluster = cluster + geo.n_j * any_push + exchange
    cta = (cta + geo.n_j * ~any_push + (not exchange)
           + max(0, geo.n_j - comp.d_w // geo.n_f))
    rows = y_rows[..., None, :] * z_rows                  # (row, tile, j, tau)
    work = (-(-rows // warps) * cells_per_row).sum((-1, -2))
    if geo.fused:
        active = comp.active.astype(bool)
        cluster, cta, work = cluster * active, cta * active, work * active
    return cluster, cta, work

