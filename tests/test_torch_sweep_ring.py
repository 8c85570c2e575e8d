"""A CPU mirror of K2's z-ring dataflow, held bitwise against `run_plain`.

``csrc/sweep.cu`` runs one CTA per (z chunk, y tile, x tile) and streams z
through one ring of cur's planes in the CTA's dynamic shared memory, laid
out by `stencil_sweep.tile_layout` (tap table, then ring). The mirror below
transcribes the kernel's index arithmetic in plain torch on one flat
NaN-filled buffer per CTA: the grid's decoding into tiles, the threads'
cells (``x + 32 v`` of rows ``y0, y0 + ry, ...``), the clipped box, the
ring slots ``k % depth``, the per-slot tap table, the prologue and the
loads `ahead` steps early, the frame taken from the ring, interior rows
updated whole with their frame columns copied over them, and the emission
of every cell. A load fills its slot with NaN when it is issued and with
cur's plane only when the kernel's wait guarantees it has landed (all but
the newest ``ahead - 1`` cp.async groups at a step's wait), so a read of a
plane in flight, of a slot overwritten too early or never loaded shows up
as a NaN or a wrong bit, and every tap of an updated cell is checked to
lie in its plane's slot. Within one plane no thread reads what another
writes, so the kernel's order of cells does not matter. The arithmetic at
a cell follows `update_cell` (as the K1 mirror's `update_cells` does).

Without a card this is what holds the kernel's design; on the card
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel itself.
"""

import re

import numpy as np
import pytest
import torch
from test_torch_mwd_ring import spec_of, update_cells

from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.kernels import _build
from repro_torch.kernels import stencil_sweep as tsweep
from repro_torch.kernels._host import hoist_groups

NAMES = list(tst.SPECS) + ["aniso11"]
ELEM = {"f32": 4, "f64": 8, "bf16": 2, "fp16": 2}


def thread_cells(plan, cy, ey, cx, ex):
    """The (y, x) cells the CTA's threads update, in the kernel's walk."""
    h = plan.tx // plan.cells
    ry = plan.threads // h
    out = []
    for t in range(plan.threads):
        xi = t % h
        x, y0 = cx + xi // 32 * 32 * plan.cells + xi % 32, cy + t // h
        if x >= ex:
            continue
        for y in range(y0, ey, ry):
            out += [(y, x + 32 * v) for v in range(plan.cells)
                    if x + 32 * v < ex]
    return out


def tap_table(spec, plan):
    """The kernel's table: ``tab[slot * n_taps + t]``."""
    taps = [t for _, members in spec.groups for t in members]
    plane = plan.width * plan.height
    tab = torch.empty((plan.depth * len(taps),), dtype=torch.long)
    for j in range(plan.depth):
        for i, t in enumerate(taps):
            j2 = ((j + t.dz) % plan.depth + plan.depth) % plan.depth
            tab[j * len(taps) + i] = ((j2 - j) * plane + t.dy * plan.width
                                      + t.dx)
    return tab


def run_cta(spec, plan, state, arrays, scalars, cz, cy, cx, out):
    cur, prev = state
    nz, ny, nx = cur.shape
    r, d = spec.radius, plan.depth
    elem, n_arr = cur.element_size(), spec.n_coeff_arrays
    taps = [t for _, members in spec.groups for t in members]
    cur_f, prev_f = cur.reshape(-1), prev.reshape(-1)
    arr_f = arrays.reshape(n_arr, -1) if n_arr else None
    ez, ey, ex = min(cz + plan.chunk, nz), min(cy + plan.ty, ny), \
        min(cx + plan.tx, nx)
    ring = plan.copy != "in-place"
    cells = thread_cells(plan, cy, ey, cx, ex)
    ys = torch.tensor([c[0] for c in cells], dtype=torch.long)
    xs = torch.tensor([c[1] for c in cells], dtype=torch.long)
    assert sorted(cells) == [(y, x) for y in range(cy, ey)
                             for x in range(cx, ex)]
    smem = torch.full((max(plan.smem_bytes, 16) // elem,), float("nan"),
                      dtype=cur.dtype)
    tab = tap_table(spec, plan) if ring else None
    tap_off = torch.tensor([t.dz * ny * nx + t.dy * nx + t.dx for t in taps])
    plane = plan.width * plan.height
    oy, ox = cy - plan.my, cx - plan.mx
    zl, zh = max(cz - r, 0), min(ez + r, nz)
    ry0, ry1 = max(oy, 0), min(oy + plan.height, ny)
    rx0, rx1 = max(ox, 0), min(ox + plan.width, nx)
    base = plan.base // elem
    assert plan.base % 16 == 0 and 4 * plan.tab_ints <= plan.base
    groups = []                     # the committed cp.async groups' planes

    def slot(k):
        return base + (k % d) * plane

    def land(k):                    # plane k's copy is complete
        if zl <= k < zh:
            for y in range(ry0, ry1):
                o = slot(k) + (y - oy) * plan.width + (rx0 - ox)
                g = k * ny * nx + y * nx
                smem[o:o + rx1 - rx0] = cur_f[g + rx0:g + rx1]

    def load(k):
        if zl <= k < zh:
            smem[slot(k):slot(k) + plane] = float("nan")    # in flight
        groups.append(k)

    def wait():                     # all but the newest ahead - 1 groups
        done = groups[:len(groups) - (plan.ahead - 1)]
        for k in done:
            land(k)
        del groups[:len(done)]

    def read(idx):                  # only within the ring
        assert bool(((idx >= base) & (idx < base + d * plane)).all())
        return smem[idx]

    if ring:
        for k in range(cz - r, cz + r + plan.ahead):
            load(k)
    for p in range(cz, ez):
        if ring:
            wait()
            load(p + r + plan.ahead)
        gf = p * ny * nx + ys * nx + xs
        frame_row = (p < r) | (p >= nz - r) | (ys < r) | (ys >= ny - r)
        frame = frame_row | (xs < r) | (xs >= nx - r)
        # in a ring every cell of an interior row is updated, its taps all
        # within the slot, and the frame columns copied over it after; in
        # place only the interior cells are
        comp = ~frame_row if ring else ~frame
        if ring:
            j = p % d
            at = slot(p) + (ys - oy) * plan.width + (xs - ox)
            val = read(at)
            for t in taps:              # each tap within its plane's slot
                yy, xx = ys[comp] + t.dy - oy, xs[comp] + t.dx - ox
                assert bool(((yy >= 0) & (yy < plan.height) & (xx >= 0)
                             & (xx < plan.width)).all())
            vals = [read(at[comp] + tab[j * len(taps) + t])
                    for t in range(len(taps))]
        else:
            val = cur_f[gf].clone()
            vals = [cur_f[gf[comp] + off] for off in tap_off]
        goff = gf[comp]
        cvals = [arr_f[a][goff] for a in range(n_arr)] if n_arr else None
        if len(goff):
            new = val.clone()
            new[comp] = update_cells(spec, vals, val[comp], prev_f[goff],
                                     cvals, scalars, None)
            val = torch.where(frame, val, new)
        assert bool(torch.isnan(out.view(-1)[gf]).all())   # written once
        out.view(-1)[gf] = val


def run_mirror(spec, plan, state, arrays, scalars):
    """One step as the kernel's grid runs it, CTA by CTA: x tiles fastest."""
    nz, ny, nx = state[0].shape
    out = torch.full_like(state[0], float("nan"))
    ntx, nty = -(-nx // plan.tx), -(-ny // plan.ty)
    for b in range(tsweep.n_ctas((nz, ny, nx), plan)):
        rest = b // ntx
        cx, zc = (b - rest * ntx) * plan.tx, rest // nty
        cy = (rest - zc * nty) * plan.ty
        run_cta(spec, plan, state, arrays, scalars, zc * plan.chunk, cy, cx,
                out)
    return out


def problem(spec, shape, dtype="f32", seed=0):
    state, coeffs = tst.make_problem(spec, shape, dtype=dtype, seed=seed,
                                     device="cpu")
    return state, *tir.split_coeffs(spec, coeffs)


def mirror_vs_plain(spec, state, arrays, scalars, n_steps, plan):
    got = want = state
    for _ in range(n_steps):
        got = (run_mirror(spec, plan, got, arrays, scalars), got[0])
        want = tsweep.run_plain(spec, want, arrays, scalars)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert not torch.isnan(a).any()
            assert torch.equal(a, b)
    return got


def layout(spec, ty, tx, elem, *, chunk, threads=64, ahead=2,
           copy="cp.async", prefetch=0):
    return tsweep.tile_layout(spec, ty, tx, elem, threads=threads,
                              chunk=chunk, ahead=ahead, copy=copy,
                              prefetch=prefetch)


def x_tile(spec, wide):
    """The narrowest x tile the instance's cells cover (32 columns a
    thread of one cell, 128 of four), or twice it."""
    return (32 if hoist_groups(spec) else 128) * (2 if wide else 1)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_mirror_bitwise_equals_plain(name, wide):
    """Tiles of 8 rows and the narrowest x tile or twice it, chunks of 6,
    none of which divides (14, 21, 140); two steps."""
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, (14, 21, 140), seed=1)
    plan = layout(spec, 8, x_tile(spec, wide), 4, chunk=6,
                  threads=128 if wide else 64, prefetch=2)
    mirror_vs_plain(spec, state, arrays, scalars, 2, plan)


@pytest.mark.parametrize("ahead", [1, 2])
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_mirror_loads_ahead(name, ahead):
    """One or two planes loaded ahead, a chunk of one plane and of the
    whole grid."""
    spec = tst.SPECS[name]
    state, arrays, scalars = problem(spec, (13, 18, 24), seed=2)
    for chunk in (1, 13):
        mirror_vs_plain(spec, state, arrays, scalars, 1,
                        layout(spec, 16, x_tile(spec, False), 4, chunk=chunk,
                               ahead=ahead))


@pytest.mark.parametrize("dt", ["f64", "bf16", "fp16"])
@pytest.mark.parametrize("name", NAMES)
def test_mirror_other_dtypes(name, dt):
    """f64 and native bf16 / fp16 at the kernel's own plan: the ring holds
    the stream type, rows aligned to 16 bytes of it."""
    spec = spec_of(name)
    shape = (14, 19, 30)
    state, arrays, scalars = problem(spec, shape, dtype=dt, seed=3)
    plan = tsweep.choose_tile(spec, shape, 8, ELEM[dt])
    assert plan.copy != "in-place" and plan.fits
    mirror_vs_plain(spec, state, arrays, scalars, 2, plan)


@pytest.mark.parametrize("name", NAMES)
def test_mirror_in_place_path(name):
    """No ring: taps read from cur itself."""
    spec = spec_of(name)
    state, arrays, scalars = problem(spec, (12, 14, 20), seed=4)
    mirror_vs_plain(spec, state, arrays, scalars, 2,
                    layout(spec, 4, 128, 4, chunk=5, threads=32,
                           copy="in-place"))


@pytest.mark.parametrize("name", ["7pt-const", "25pt-var"])
def test_mirror_chosen_plan_on_odd_grid(name):
    """The kernel's own plan on a grid with unaligned rows (nx = 29)."""
    spec = tst.SPECS[name]
    shape = (17, 23, 29)
    state, arrays, scalars = problem(spec, shape, seed=5)
    for bz in (1, 3, 8, 40):
        plan = tsweep.choose_tile(spec, shape, bz, 4)
        assert plan.chunk % bz == 0 and plan.copy == "cp.async"
        mirror_vs_plain(spec, state, arrays, scalars, 1, plan)


def test_mirror_many_threads_few_columns():
    """More threads than the tile has cells: idle threads and rows."""
    for name, tx in (("7pt-var", 64), ("7pt-const", 128)):
        spec = tst.SPECS[name]
        state, arrays, scalars = problem(spec, (9, 10, 11), seed=6)
        mirror_vs_plain(spec, state, arrays, scalars, 1,
                        layout(spec, 4, tx, 4, chunk=4, threads=256))


@pytest.mark.parametrize("bz", [1, 2, 3, 8, 100, 1000])
@pytest.mark.parametrize("dt", ["f32", "f64", "bf16", "fp16"])
@pytest.mark.parametrize("name", NAMES)
def test_chosen_tile_fits_shared_memory(name, dt, bz):
    """Every op x dtype x bz at 512^3 and a small grid has a plan within the
    232,448 bytes a block may take, its chunk a whole multiple of bz, laid
    out without overlap, with whole rows for its threads."""
    spec = spec_of(name)
    elem = ELEM[dt]
    for shape in ((512, 512, 512), (37, 53, 29)):
        plan = tsweep.choose_tile(spec, shape, bz, elem)
        assert plan.fits and plan.smem_bytes <= 232_448
        assert plan.chunk % bz == 0 and plan.ctas_per_sm >= 1
        assert plan.copy == "cp.async"
        h = plan.tx // plan.cells
        assert plan.threads % h == 0 and h % 32 == 0
        assert plan.cells == (1 if plan.hoist else 2 if elem == 8 else 4)
        r = spec.radius
        assert plan.depth == 2 * r + 1 + plan.ahead
        assert plan.my == r and plan.height == plan.ty + 2 * r
        assert plan.mx >= r and plan.mx * elem % 16 == 0
        assert plan.width >= plan.mx + plan.tx + r
        assert plan.width * elem % 16 == 0
        assert 4 * plan.tab_ints <= plan.base
        assert plan.base % 16 == 0 and plan.smem_bytes == (
            plan.base + plan.depth * plan.height * plan.width * elem)


def test_large_radius_reads_in_place():
    """A radius no ring fits (R = 40, f64) takes the in-place instance; the
    mirror holds it on a grid wide enough for an interior."""
    taps = (tir.Tap(0, 0, 0, tir.const(0)), tir.Tap(40, 0, 0, tir.const(1)),
            tir.Tap(-40, 0, 0, tir.const(1)), tir.Tap(0, 0, 40, tir.const(1)))
    spec = tir.StencilOp("far", taps, default_scalars=(0.5, 0.25))
    plan = tsweep.choose_tile(spec, (512, 512, 512), 8, 8)
    assert plan.copy == "in-place" and plan.smem_bytes == 0
    shape = (82, 81, 84)
    state, arrays, scalars = problem(spec, shape, dtype="f64", seed=7)
    mirror_vs_plain(spec, state, arrays, scalars, 1,
                    tsweep.choose_tile(spec, shape, 8, 8))


@pytest.mark.parametrize("name", NAMES)
def test_measured_plan_by_kind_of_op(name):
    """The paper ops take their own measured plan at 512^3, f32; the L2
    prefetch only where the op has prev or coefficient streams."""
    spec = spec_of(name)
    t = tsweep.measured_tile(spec)
    plan = tsweep.choose_tile(spec, (512, 512, 512), 8, 4)
    assert (plan.ty, plan.tx, plan.threads, plan.ahead) == (
        t["ty"], t["tx"], t["threads"], t["ahead"])
    assert plan.chunk == t["chunk"]
    streams = spec.time_order == 2 or spec.n_coeff_arrays
    assert plan.prefetch == (t["prefetch"] if streams else 0)
    kinds = {"7pt-const": "plain", "7pt-var": "hoisted",
             "25pt-var": "hoisted-wide", "25pt-const": "streams",
             "aniso11": "hoisted-wide"}
    assert t is tsweep.TILES[kinds[name]]


def test_layout_refuses_what_the_kernel_does_not_build():
    spec = tst.SPECS["7pt-const"]
    with pytest.raises(ValueError, match="whole warps"):
        layout(spec, 8, 128, 4, chunk=8, threads=48)
    with pytest.raises(ValueError, match="ahead"):
        layout(spec, 8, 128, 4, chunk=8, ahead=3)
    with pytest.raises(ValueError, match="prefetches"):
        layout(spec, 8, 128, 4, chunk=8, prefetch=tsweep.MAX_PREFETCH + 1)
    with pytest.raises(ValueError, match="whole rows"):
        layout(spec, 8, 256, 4, chunk=8, threads=32)
    with pytest.raises(ValueError, match="multiple of 128"):
        layout(spec, 8, 64, 4, chunk=8)
    with pytest.raises(ValueError, match="multiple of 32"):
        layout(tst.SPECS["7pt-var"], 8, 48, 4, chunk=8)
    with pytest.raises(ValueError, match="copy path"):
        layout(spec, 8, 128, 4, chunk=8, copy="bulk")


@pytest.mark.parametrize("macro,value", [
    ("SWEEP_MAX_THREADS", tsweep.MAX_THREADS),
    ("SWEEP_MAX_AHEAD", tsweep.MAX_AHEAD),
    ("SWEEP_MAX_SMEM", tsweep.SMEM_PER_BLOCK),
    ("SWEEP_MAX_PREFETCH", tsweep.MAX_PREFETCH),
    ("SWEEP_GEO_LEN", tsweep.GEO_LEN)])
def test_host_limits_match_the_kernel(macro, value):
    src = (_build.CSRC / "sweep.cu").read_text()
    m = re.search(rf"#define {macro} (\d+)", src)
    assert m and int(m.group(1)) == value


def test_geometry_table_matches_the_kernels_reader():
    """`_geometry` writes the fields `read_geo` reads, in its order."""
    src = (_build.CSRC / "sweep.cu").read_text()
    body = src[src.index("static int read_geo"):]
    body = body[:body.index("g.n_taps = n_taps;")]
    fields = dict((int(i), f) for f, i in
                  re.findall(r"g\.(\w+) = \(int\)geo\[(\d+)\]", body))
    assert sorted(fields) == list(range(tsweep.GEO_LEN))
    spec = tst.SPECS["25pt-var"]
    for copy in tsweep.COPIES:
        plan = layout(spec, 8, 128, 4, chunk=24, threads=128, copy=copy,
                      prefetch=3)
        geo = tsweep._geometry(spec, (20, 30, 64), plan)
        assert geo.dtype == np.int64 and len(geo) == tsweep.GEO_LEN
        want = dict(nz=20, ny=30, nx=64, chunk=20, ty=8, tx=128, threads=128,
                    radius=4, ahead=2, hoist=16 if copy == "cp.async" else 0,
                    ring=int(copy == "cp.async"), n_arrays=13,
                    smem_bytes=plan.smem_bytes, tab_ints=plan.tab_ints,
                    mx=plan.mx, my=plan.my, width=plan.width,
                    height=plan.height, depth=plan.depth, base=plan.base,
                    prefetch=3)
        assert {fields[i]: int(v) for i, v in enumerate(geo)} == want


def test_tile_bound_counts_clipped_boxes():
    """`tile_bytes` for one tile over the grid: every stream once; for
    two x tiles, cur's box widened on the inner sides."""
    spec = tst.SPECS["7pt-var"]
    shape = (6, 8, 32)
    cells = 6 * 8 * 32
    plan = layout(spec, 8, 32, 4, chunk=6)
    assert tsweep.tile_bytes(spec, shape, plan, 4) == (
        cells * (1 + spec.n_coeff_arrays + 1)) * 4
    shape = (6, 8, 256)
    cells = 6 * 8 * 256
    plan = layout(tst.SPECS["7pt-const"], 8, 128, 4, chunk=6, threads=32)
    # x tiles [0, 128) and [128, 256); the second loads from 128 - mx = 124
    assert tsweep.tile_bytes(tst.SPECS["7pt-const"], shape, plan, 4) == (
        6 * 8 * (132 + 132) + cells) * 4
