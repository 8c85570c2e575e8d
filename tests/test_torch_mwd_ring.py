"""A CPU mirror of K1's cluster dataflow, held bitwise against `run_plain`.

``csrc/mwd.cu`` runs one thread-block cluster per diamond tile: each CTA
owns an x-slab, keeps a z-ring of both parity windows (and of the
coefficient streams, unpadded, where they are staged) in shared memory,
pushes the R boundary columns it writes into its neighbours' halos after
every update whose parity a later update reads, and emits the tile's own
rows once they are final. The mirror below transcribes that index
arithmetic line by line in plain torch: the ring slots ``z mod depth``,
the per-slot tap table, the loads one or two steps ahead (coefficients R
rows behind), the rule for which updates push, the halo pushes and the
emission, on NaN-filled rings, so a read of a slot that was never loaded
or already reused, or of a halo that was not pushed, shows up. The CTAs of
one cluster run in lockstep per update; within an update no CTA reads
what another writes, so their order does not matter (the kernel's split
into loads ahead, updates and barriers is a schedule of the same reads
and writes). The arithmetic at a cell follows `update_cell` (and
`ir.sweep_region`): taps summed in `op.groups` order, one multiply per
group, groups accumulated in order.

Without a card this is what holds the kernel's design; on the card
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel itself.
"""

import pytest
import torch

from repro_torch.core import ir as tir
from repro_torch.core import models as tmodels
from repro_torch.core import stencils as tst
from repro_torch.kernels import stencil_mwd as tkern

GRID = (16, 24, 20)


def aniso11():
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [tir.Tap(0, 0, 0, tir.array(0)),
            tir.Tap(-1, 0, 0, tir.array(1)), tir.Tap(1, 0, 0, tir.array(1)),
            tir.Tap(0, -1, 0, tir.array(2)), tir.Tap(0, 1, 0, tir.array(2))]
    taps += [tir.Tap(0, 0, s * d, tir.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return tir.StencilOp("aniso11", tuple(taps),
                         default_scalars=(0.08, 0.04, 0.02))


def spec_of(name):
    return aniso11() if name == "aniso11" else tst.SPECS[name]


def d_w_of(spec):
    return 12 if spec.radius == 3 else 8


def ring_depths(job):
    """Slabs in flight and the parity and coefficient ring depths in z rows,
    as the launcher sets them."""
    r, t, nf = job.op.radius, job.comp.t_steps, job.n_f
    ahead = 1 if t >= 4 else 2
    return ahead, (ahead + 1) * nf + t * r + r, (ahead + 1) * nf + r * (t - 1)


def halo_pushes(spans, t_steps, has_x):
    """Which updates push their halos: those with cells that a later update
    of the tile, an odd number of updates on, reads (it has cells too)."""
    live = [spans[t][1] > spans[t][0] and has_x for t in range(t_steps)]
    return [live[t] and any(live[u] for u in range(t + 1, t_steps, 2))
            for t in range(t_steps)]


def tap_table(op, depth, plane, wx):
    """``tab[s, t]``: offset of tap t from a cell in ring slot s (mwd.cu)."""
    taps = [t for _, members in op.groups for t in members]
    tab = torch.empty((depth, len(taps)), dtype=torch.long)
    for s in range(depth):
        for i, t in enumerate(taps):
            s2 = ((s + t.dz) % depth + depth) % depth
            tab[s, i] = (s2 - s) * plane + t.dy * wx + t.dx
    return tab


def slabs(job, slab):
    """(first column, width) of every CTA of the cluster, padded x."""
    lo_x, hi_x = job.bounds[4:6]
    nxr = max(hi_x - lo_x, 0)
    cluster = max(1, -(-nxr // slab))
    return [(lo_x + c * slab, max(min(slab, hi_x - lo_x - c * slab), 0))
            for c in range(cluster)]


def update_cells(op, vals, centre, prev, cvals, scalars, acc):
    """update_cell over a vector of cells; vals[t] per tap, group order."""
    up = (lambda v: v) if acc is None else (lambda v: v.to(acc))
    total, t = None, 0
    for coeff, members in op.groups:
        s = None
        for _ in members:
            v = up(vals[t])
            t += 1
            s = v if s is None else s + v
        c = (scalars[coeff.index] if coeff.kind == "const"
             else up(cvals[coeff.index]))
        term = c * s
        total = term if total is None else total + term
    if op.time_order == 2:
        lead = 2.0 * up(centre) - up(prev)
        if op.scale is None:
            total = lead + total
        elif op.scale.kind == "const":
            total = lead + scalars[op.scale.index] * total
        else:
            total = lead + up(cvals[op.scale.index]) * total
    return total if acc is None else total.to(prev.dtype)


def run_tile(job, i, k, slab, stage, p0):
    """One cluster: tile k of row i, every CTA in lockstep.

    Returns the cluster barriers each CTA passes: one after every update
    that pushes halos, one at the end of every step of a tile that pushes.
    """
    op, comp = job.op, job.comp
    r, t_steps, nf, d_w = op.radius, comp.t_steps, job.n_f, comp.d_w
    ahead, depth, cdepth = ring_depths(job)
    e = 16 // job.bufs[0].element_size()     # window rows: whole 16 bytes
    wy, wx = d_w + 2 * r, -(-(slab + 2 * r) // e) * e
    plane = wy * wx
    lo_z, hi_z, lo_y, hi_y, lo_x, hi_x = job.bounds
    pz, py, px = job.pads
    nz, ny, nx = job.cur.shape[-3:]
    lead = job.bufs[0].shape[:-3]
    n_arr = op.n_coeff_arrays
    stage = stage and n_arr > 0
    ctas = slabs(job, slab)
    w0 = int(comp.w0[i, k]) + py
    yo = w0 + r
    nan = dict(dtype=job.bufs[0].dtype)
    win = [torch.full(lead + (2, depth * plane), float("nan"), **nan)
           for _ in ctas]
    cwin = [torch.full(lead + (n_arr, cdepth * d_w * slab), float("nan"),
                       **nan) for _ in ctas] if stage else None
    cglob = (job.coeff.reshape(lead + (n_arr, nz * ny * nx))
             if n_arr else None)
    tab = tap_table(op, depth, plane, wx)
    spans = [(max(int(comp.y0[i, k, t]) + py, lo_y),
              min(int(comp.y1[i, k, t]) + py, hi_y)) for t in range(t_steps)]
    push = halo_pushes(spans, t_steps, hi_x > lo_x)

    def load(j):
        for c, (x0, w) in enumerate(ctas):
            for p in (0, 1):
                for z in range(j * nf, (j + 1) * nf):
                    for y in range(wy):
                        o = (z % depth) * plane + y * wx
                        win[c][..., p, o:o + w + 2 * r] = \
                            job.bufs[p][..., z, w0 + y, x0 - r:x0 + w + r]
            if not stage:
                continue
            for z in range(j * nf - r, (j + 1) * nf - r):
                for y in range(yo, yo + d_w):
                    zu, yu = z - pz, y - py
                    if not (0 <= zu < nz and 0 <= yu < ny):
                        continue
                    o = (z % cdepth) * d_w * slab + (y - yo) * slab
                    g = zu * ny * nx + yu * nx + (x0 - px)
                    cwin[c][..., :, o:o + w] = cglob[..., :, g:g + w]

    barriers = 0
    for j in range(min(ahead, job.n_j)):
        load(j)
    for j in range(job.n_j):
        if j + ahead < job.n_j:
            load(j + ahead)
        barriers += any(push)                   # the step's last barrier
        for tau in range(t_steps):
            zs = j * nf - (tau + 1) * r
            z0, z1 = max(zs, lo_z), min(zs + nf, hi_z)
            ya, yb = spans[tau]
            if not (z1 > z0 and yb > ya and hi_x > lo_x):
                continue
            barriers += push[tau] and tau < t_steps - 1
            pp = (p0 + tau) % 2
            for c, (x0, w) in enumerate(ctas):
                z, y, x = (a.reshape(-1) for a in torch.meshgrid(
                    torch.arange(z0, z1), torch.arange(ya, yb),
                    torch.arange(w), indexing="ij"))
                slot = z % depth
                cell = slot * plane + (y - w0) * wx + r + x
                vals = [win[c][..., pp, cell + tab[slot, t]]
                        for t in range(tab.shape[1])]
                prev = win[c][..., 1 - pp, cell]
                cvals = None
                if stage:
                    co = (z % cdepth) * d_w * slab + (y - yo) * slab + x
                    cvals = [cwin[c][..., a, co] for a in range(n_arr)]
                elif n_arr:
                    co = ((z - pz) * ny * nx + (y - py) * nx
                          + (x0 - px) + x)
                    cvals = [cglob[..., a, co] for a in range(n_arr)]
                new = update_cells(op, vals, win[c][..., pp, cell], prev,
                                   cvals, job.scalars, job.acc_dtype)
                win[c][..., 1 - pp, cell] = new
                if not push[tau]:
                    continue
                if c > 0:                       # left neighbour's right halo
                    m = x < r
                    win[c - 1][..., 1 - pp, cell[m] + slab] = new[..., m]
                if c + 1 < len(ctas):           # right neighbour's left halo
                    m = x >= w - r
                    win[c + 1][..., 1 - pp, cell[m] - slab] = new[..., m]
        if j >= d_w // nf:                      # rows [j*nf - d_w, +nf) final
            for c, (x0, w) in enumerate(ctas):
                for p in (0, 1):
                    for z in range(j * nf - d_w, j * nf - d_w + nf):
                        for y in range(yo, yo + d_w):
                            o = (z % depth) * plane + (y - w0) * wx + r
                            job.bufs[p][..., z, y, x0:x0 + w] = \
                                win[c][..., p, o:o + w]
    return barriers


def run_mirror(job, slab, stage=True):
    """The kernel's launches, row by row; tiles of a row in row-major order.

    Returns the cluster barriers per (row, tile), as `run_tile` counts them.
    """
    comp = job.comp
    barriers = torch.zeros((comp.n_rows, comp.n_tiles), dtype=torch.long)
    for i in range(comp.n_rows):
        if not job.fused:
            job.bufs = [b.clone() for b in job.bufs]
        for k in range(comp.n_tiles):
            if job.fused and not comp.active[i, k]:
                continue
            barriers[i, k] = run_tile(job, i, k, slab, stage,
                                      int(comp.parity[i]))
    return barriers


def mirror_vs_plain(spec, state, arrays, scalars, n_steps, slab, stage=True,
                    **kw):
    jobs = [tkern.prepare(spec, state, arrays, scalars, n_steps, **kw)
            for _ in range(2)]
    barriers = run_mirror(jobs[0], slab, stage)
    tkern.run_plain(jobs[1])
    for a, b in zip(jobs[0].bufs, jobs[1].bufs):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert not torch.isnan(a).any()
        assert torch.equal(a, b)
    return jobs, barriers


# slab widths against the interior x width of GRID (nx=20 less 2R): one that
# divides it and one that leaves a narrower last CTA (narrower than R at R=4)
SLABS = {1: (6, 7), 3: (7, 5), 4: (6, 5)}
NAMES = list(tst.SPECS) + ["aniso11"]


def problem(spec, shape=GRID, dtype="f32", seed=0, batch=None):
    if batch is None:
        state, coeffs = tst.make_problem(spec, shape, dtype=dtype, seed=seed,
                                         device="cpu")
        return state, *tir.split_coeffs(spec, coeffs)
    probs = [problem(spec, shape, dtype, seed + b) for b in range(batch)]
    state = tuple(torch.stack([p[0][i] for p in probs]) for i in (0, 1))
    arrays = (torch.stack([p[1] for p in probs])
              if spec.n_coeff_arrays else None)
    return state, arrays, probs[0][2]


@pytest.mark.parametrize("divides", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_mirror_bitwise_equals_plain(name, divides):
    spec = spec_of(name)
    slab = SLABS[spec.radius][0 if divides else 1]
    nxr = GRID[2] - 2 * spec.radius
    assert (nxr % slab == 0) == divides
    state, arrays, scalars = problem(spec, seed=1)
    n_steps = 5 if spec.radius == 1 else 3
    mirror_vs_plain(spec, state, arrays, scalars, n_steps, slab,
                    d_w=d_w_of(spec), n_f=2, fused=True)


# requested cluster sizes against the interior x width of GRID (nx = 20
# less 2R): the sizes the slab rounding reaches, and one it does not
FORCED = {1: ((1, 2, 3, 5), 4), 3: ((1, 2, 4), 3), 4: ((1, 2, 3), 4)}


@pytest.mark.parametrize("name", NAMES)
def test_mirror_at_a_requested_cluster_bitwise_equals_plain(name):
    """`prepare(cluster=c)`: c CTAs a tile at the slab the launcher's
    rounding gives them (the fit twin's), the staging it picks; a size the
    rounding does not reach is refused, never swapped for another."""
    spec = spec_of(name)
    sizes, refused = FORCED[spec.radius]
    state, arrays, scalars = problem(spec, seed=8)
    kw = dict(d_w=d_w_of(spec), n_f=2, fused=True)
    for c in sizes:
        plan = tmodels.mwd_smem_plan(spec, kw["d_w"], 2, GRID[2], 4,
                                     cluster=c)
        assert plan.cluster == c
        (job, _), _ = mirror_vs_plain(spec, state, arrays, scalars, 4,
                                      plan.slab, stage=bool(plan.stage),
                                      cluster=c, **kw)
        assert len(slabs(job, plan.slab)) == c
        assert job.cluster == c and tkern._geometry(job)[25] == c
    nxr = GRID[2] - 2 * spec.radius
    assert tmodels.mwd_cluster_slab(nxr, refused, 4)[1] != refused
    assert tmodels.mwd_smem_plan(spec, kw["d_w"], 2, GRID[2], 4,
                                 cluster=refused) is None


def test_requested_cluster_in_the_geometry_table():
    """0 asks the kernel to choose; the exchange flag stays last."""
    spec = tst.SPECS["7pt-var"]
    state, arrays, scalars = problem(spec, seed=9)
    job = tkern.prepare(spec, state, arrays, scalars, 3, d_w=8, n_f=2,
                        fused=True)
    geo = tkern._geometry(job)
    assert len(geo) == 27 and geo[25] == 0 and job.cluster is None
    for bad in (0, tkern.MAX_CLUSTER + 1):
        with pytest.raises(ValueError, match="cluster"):
            tkern.prepare(spec, state, arrays, scalars, 3, d_w=8, n_f=2,
                          fused=True, cluster=bad)


@pytest.mark.parametrize("name", ["7pt-var", "25pt-var", "aniso11"])
def test_mirror_unstaged_coefficients_read_unpadded(name):
    """Coefficients read from the caller's unpadded streams at the cell."""
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, seed=2)
    mirror_vs_plain(spec, state, arrays, scalars, 4, SLABS[spec.radius][1],
                    stage=False, d_w=d_w_of(spec), n_f=2, fused=True)


@pytest.mark.parametrize("name", NAMES)
def test_mirror_batched_per_row_nf4(name):
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, shape=(12, 20, 16), seed=3,
                                     batch=2)
    mirror_vs_plain(spec, state, arrays, scalars, 3, SLABS[spec.radius][1],
                    d_w=d_w_of(spec), n_f=4, fused=False)


@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_mirror_runtime_interior_and_y_domain(name):
    """The distributed stepper's dynamic interior and full-y tessellation."""
    spec = spec_of(name)
    r = spec.radius
    state, arrays, scalars = problem(spec, shape=(14, 24, 20), seed=4)
    interior = (r + 1, 14 - r - 2, r, 24 - r - 1, r + 2, 20 - r - 1)
    mirror_vs_plain(spec, state, arrays, scalars, 4, 5, d_w=8, n_f=2,
                    fused=True, interior=interior, y_domain=(0, 24))


@pytest.mark.parametrize("dt,acc", [("bf16", torch.float32), ("fp16", None)])
def test_mirror_reduced_precision(dt, acc):
    spec = tst.SPECS["7pt-var"]
    state, arrays, scalars = problem(spec, dtype=dt, seed=5)
    mirror_vs_plain(spec, state, arrays, scalars, 5, 7, d_w=8, n_f=2,
                    fused=True, acc_dtype=acc)


@pytest.mark.parametrize("name", NAMES)
def test_launch_runs_clusters_where_some_update_pushes(name):
    """The host's push rule (which also decides whether the launches run
    as clusters) equals the mirror's, tile by tile."""
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, seed=6)
    job = tkern.prepare(spec, state, arrays, scalars, 5, d_w=d_w_of(spec),
                        n_f=2, fused=True)
    comp, py = job.comp, job.pads[1]
    lo_y, hi_y, lo_x, hi_x = job.bounds[2:]
    push, _ = tkern.halo_schedule(job)
    for i in range(comp.n_rows):
        for k in range(comp.n_tiles):
            spans = [(max(int(comp.y0[i, k, t]) + py, lo_y),
                      min(int(comp.y1[i, k, t]) + py, hi_y))
                     for t in range(comp.t_steps)]
            assert (push[i, k].tolist()
                    == halo_pushes(spans, comp.t_steps, hi_x > lo_x))
    assert push.any() == (spec.radius < 4)  # T = 2 at dw8: nothing to push
    assert tkern._geometry(job)[-1] == int(push.any())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_host_barrier_count_equals_the_mirrors(name, fused):
    """`halo_schedule`'s barriers per (row, tile), which the chip check
    prices, are the ones the mirror's CTAs pass."""
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, seed=7)
    kw = dict(d_w=d_w_of(spec), n_f=2, fused=fused)
    (job, _), barriers = mirror_vs_plain(spec, state, arrays, scalars, 5,
                                         SLABS[spec.radius][0], **kw)
    _, want = tkern.halo_schedule(tkern.prepare(spec, state, arrays,
                                                scalars, 5, **kw))
    assert barriers.tolist() == want.tolist()
    assert (barriers.sum() > 0) == (spec.radius < 4)


def test_tap_table_addresses_the_wrapped_rows():
    spec = tst.SPECS["25pt-var"]
    depth, wy, wx = 16, 16, 40
    tab = tap_table(spec, depth, wy * wx, wx)
    taps = [t for _, members in spec.groups for t in members]
    for s in range(depth):
        base = s * wy * wx + 8 * wx + 20            # a cell of slot s
        for i, t in enumerate(taps):
            at = base + int(tab[s, i])
            assert at // (wy * wx) == (s + t.dz) % depth
            assert at % (wy * wx) == (8 + t.dy) * wx + 20 + t.dx


def test_prepare_hands_the_coefficients_over_uncopied():
    spec = tst.SPECS["7pt-var"]
    state, arrays, scalars = problem(spec, shape=(8, 14, 10))
    job = tkern.prepare(spec, state, arrays, scalars, 3, d_w=8, n_f=2,
                        fused=True)
    assert job.coeff is arrays
    assert job.bufs[0].shape[-3:] != arrays.shape[-3:]     # grids padded
    batched, barr, bsc = problem(spec, shape=(8, 14, 10), batch=2)
    bjob = tkern.prepare(spec, batched, barr, bsc, 3, d_w=8, n_f=2,
                         fused=True)
    assert bjob.coeff.data_ptr() == barr.data_ptr()
