"""A CPU mirror of K3's z-ring dataflow, held bitwise against `run_plain`.

``csrc/fused.cu`` runs one CTA per (z chunk, y tile, x tile) and keeps
every level of a ghost-zone pass on chip: level s < t_block in a ring of
planes over its own box, the centre widened by ``(t_block - s) * R``, in
the CTA's dynamic shared memory as `stencil_fused.choose_tile` lays it out
(tap tables first, then the rings). The mirror below transcribes the
kernel's index arithmetic in plain torch on one flat NaN-filled buffer per
CTA: the y sub-tiles of a block, the ring slots ``k % depth``, the
per-(ring, slot) tap tables, the steps of one or two planes, the loads of
cur `LOAD_AHEAD` steps early, issued at the start of a step before any
level of that step runs, the clipped boxes, the frame taken from cur (from
the level-0 ring while it holds the plane), the 2nd-order read of level s-2
and the emission of level t_block to out_cur and of level t_block - 1 to
out_prev, and a pass split into launches (`stencil_fused.launch_steps`). A
read of a slot that was never written or already reused shows up as a NaN
or a wrong bit. Within one level no thread reads what another writes, so
the kernel's order of cells and planes does not matter. The arithmetic at
a cell follows `update_cell` (as the K1 mirror's `update_cells` does).

Without a card this is what holds the kernel's design; on the card
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold the kernel itself.
"""

import re

import pytest
import torch
from test_torch_mwd_ring import spec_of, update_cells

from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.kernels import _build
from repro_torch.kernels import stencil_fused as tfused

NAMES = list(tst.SPECS) + ["aniso11"]
GRID = (24, 40, 36)


def tap_tables(spec, plan):
    """The kernel's table: ``tab[ring.tab + slot * n_taps + t]``."""
    taps = [t for _, members in spec.groups for t in members]
    tab = torch.full((plan.tab_ints,), -(1 << 40), dtype=torch.long)
    for q in plan.rings:
        if q is None:
            continue
        for j in range(q.depth):
            for i, t in enumerate(taps):
                j2 = ((j + t.dz) % q.depth + q.depth) % q.depth
                tab[q.tab + j * len(taps) + i] = ((j2 - j) * q.plane
                                                  + t.dy * q.width + t.dx)
    return tab


def run_cta(spec, plan, state, arrays, scalars, t_block, bz, cz, cy, ey, cx,
            out):
    cur, prev = state
    nz, ny, nx = cur.shape
    r, T, bx, P = spec.radius, t_block, plan.bx, plan.planes
    elem, n_arr = cur.element_size(), spec.n_coeff_arrays
    taps = [t for _, members in spec.groups for t in members]
    cur_f, prev_f = cur.reshape(-1), prev.reshape(-1)
    arr_f = arrays.reshape(n_arr, -1) if n_arr else None
    smem = torch.full((plan.smem_bytes // elem,), float("nan"),
                      dtype=cur.dtype)
    tab = tap_tables(spec, plan)
    tap_off = torch.tensor([t.dz * ny * nx + t.dy * nx + t.dx for t in taps])
    ez, ex = min(cz + bz, nz), min(cx + bx, nx)
    in_place = plan.layout == "cur-in-place"

    def slot(q, k):                     # first element of plane k's slot
        return q.base // elem + (k % q.depth) * q.plane

    def cell(q, y, x):
        return (y - (cy - q.my)) * q.width + (x - (cx - q.mx))

    def read(q, idx):                   # only within ring q's own planes
        lo = q.base // elem
        assert bool(((idx >= lo) & (idx < lo + q.depth * q.plane)).all())
        return smem[idx]

    def load_plane(q, dst, src, k):
        oy, ox = cy - q.my, cx - q.mx
        x0, x1 = max(ox, 0), min(ox + q.width, nx)
        for y in range(max(oy, 0), min(oy + q.height, ny)):
            o = dst + (y - oy) * q.width + (x0 - ox)
            g = k * ny * nx + y * nx
            smem[o:o + x1 - x0] = src[g + x0:g + x1]

    z0, z0e = max(cz - T * r, 0), min(ez + T * r, nz)

    def load(k):                        # cur planes k ... k + P - 1
        if not in_place:
            for kk in range(max(k, z0), min(k + P, z0e)):
                load_plane(plan.rings[0], slot(plan.rings[0], kk), cur_f, kk)

    def level_plane(s, p, m):           # level s at plane p
        yf, xf = (a.reshape(-1) for a in torch.meshgrid(
            torch.arange(max(cy - m, 0), min(ey + m, ny)),
            torch.arange(max(cx - m, 0), min(ex + m, nx)),
            indexing="ij"))
        gf = p * ny * nx + yf * nx + xf
        frame = ((p < r) | (p >= nz - r) | (yf < r) | (yf >= ny - r)
                 | (xf < r) | (xf >= nx - r))
        q0 = plan.rings[0]
        if not in_place and s <= 2:
            val = read(q0, slot(q0, p) + cell(q0, yf, xf))
        else:
            val = cur_f[gf].clone()
        y, x, goff = yf[~frame], xf[~frame], gf[~frame]
        if s > 1 or not in_place:
            qa = plan.rings[s - 1]
            src = slot(qa, p) + cell(qa, y, x)
            t0 = qa.tab + (p % qa.depth) * len(taps)
            vals = [read(qa, src + tab[t0 + t]) for t in range(len(taps))]
            centre = read(qa, src)
        else:
            vals = [cur_f[goff + off] for off in tap_off]
            centre = cur_f[goff]
        if s == 1:
            pv = prev_f[goff]
        elif s == 2 and in_place:
            pv = cur_f[goff]
        else:
            qb = plan.rings[s - 2]
            pv = read(qb, slot(qb, p) + cell(qb, y, x))
        cvals = [arr_f[a][goff] for a in range(n_arr)] if n_arr else None
        val[~frame] = update_cells(spec, vals, centre, pv, cvals, scalars,
                                   None)
        if s < T:
            q = plan.rings[s]
            smem[slot(q, p) + cell(q, yf, xf)] = val
        else:
            out[0].view(-1)[gf] = val
        if s == T - 1 and cz <= p < ez:
            c = (yf >= cy) & (yf < ey) & (xf >= cx) & (xf < ex)
            out[1].view(-1)[gf[c]] = val[c]

    ahead = tfused.LOAD_AHEAD
    for a in range(ahead):
        load(z0 + a * P)
    for k in range(z0, ez + T * r, P):
        load(k + ahead * P)
        if T == 1:
            for p in range(max(k, cz), min(k + P, ez)):
                out[1][p, cy:ey, cx:ex] = cur[p, cy:ey, cx:ex]
        for s in range(1, T + 1):
            m = (T - s) * r
            for p in range(max(k - s * r, cz - m, 0),
                           min(k - s * r + P, ez + m, nz)):
                level_plane(s, p, m)


def run_mirror(spec, plan, state, arrays, scalars, t_block, bz, by):
    """One launch as the kernel's grid runs it: (out_cur, out_prev). A
    block of by rows is split into y tiles of plan.ty rows."""
    nz, ny, nx = state[0].shape
    out = (torch.full_like(state[0], float("nan")),
           torch.full_like(state[0], float("nan")))
    for cz in range(0, nz, bz):
        for yb in range(0, ny, by):
            for cy in range(yb, min(yb + by, ny), plan.ty):
                ey = min(cy + plan.ty, yb + by, ny)
                for cx in range(0, nx, plan.bx):
                    run_cta(spec, plan, state, arrays, scalars, t_block, bz,
                            cz, cy, ey, cx, out)
    return out


def problem(spec, shape, dtype="f32", seed=0):
    state, coeffs = tst.make_problem(spec, shape, dtype=dtype, seed=seed,
                                     device="cpu")
    return state, *tir.split_coeffs(spec, coeffs)


def mirror_vs_plain(spec, state, arrays, scalars, n_steps, t_block, bz, by,
                    plan_of):
    """Passes of the mirror against `run_plain`; `plan_of(tb)` lists the
    (steps, plan) of each launch of a pass of tb steps."""
    got = want = state
    for tb in tfused.pass_lengths(n_steps, t_block):
        for t, plan in plan_of(tb):
            got = run_mirror(spec, plan, got, arrays, scalars, t, bz, by)
        want = tfused.run_plain(spec, want, arrays, scalars, tb, bz=bz,
                                by=by)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert not torch.isnan(a).any()
            assert torch.equal(a, b)
    return got


def chosen(spec, by, nx, elem):
    """The kernel's own launches and plans, as `run_kernel` takes them."""
    return lambda tb: [(t, tfused.choose_tile(spec, t, by, nx, elem))
                       for t in tfused.launch_steps(spec, tb, by, nx, elem)]


def fixed(spec, ty, bx, elem, layout="all-rings", planes=1, threads=256):
    return lambda tb: [(tb, tfused.tile_layout(
        spec, tb, ty, bx, elem, layout=layout, threads=threads,
        planes=planes))]


@pytest.mark.parametrize("t_block", [1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_mirror_bitwise_equals_plain(name, t_block):
    """The kernel's own plan at the defaults bz = by = 16, which divide
    neither nz nor ny here; the chosen bx leaves a narrower last x tile."""
    spec = spec_of(name)
    shape = GRID if spec.radius == 1 else (20, 24, 36)
    state, arrays, scalars = problem(spec, shape, seed=1)
    plan = tfused.choose_tile(spec, t_block, 16, shape[2], 4)
    assert shape[2] % plan.bx
    mirror_vs_plain(spec, state, arrays, scalars, t_block, t_block, 16, 16,
                    chosen(spec, 16, shape[2], 4))


@pytest.mark.parametrize("name", NAMES)
def test_mirror_dividing_tiles_and_short_last_pass(name):
    """bz, by and bx that divide the grid; 5 steps in passes of 3 and 2."""
    spec = spec_of(name)
    shape = (24, 40, 32) if spec.radius == 1 else (16, 24, 32)
    state, arrays, scalars = problem(spec, shape, seed=2)
    mirror_vs_plain(spec, state, arrays, scalars, 5, 3, 8, 8,
                    fixed(spec, 8, 16, 4))


@pytest.mark.parametrize("t_block", [1, 2, 3])
@pytest.mark.parametrize("name", ["7pt-const", "25pt-const"])
def test_mirror_two_planes_a_step(name, t_block):
    """Two planes a step (level 0 in place, ops without array-coefficient
    groups): rings of 2R + 2 planes, level s at planes k - sR and k - sR + 1
    from one barrier to the next; passes of t_block and a short last one,
    odd bz and by."""
    spec = spec_of(name)
    shape = (17, 21, 28)
    state, arrays, scalars = problem(spec, shape, seed=3)
    mirror_vs_plain(spec, state, arrays, scalars, t_block + 2, t_block, 7, 9,
                    fixed(spec, 9, 16, 4, layout="cur-in-place", planes=2))


@pytest.mark.parametrize("name,layout", [
    ("7pt-var", "cur-in-place"), ("aniso11", "cur-in-place"),
    ("25pt-var", "cur-in-place"), ("7pt-const", "all-rings")])
def test_two_planes_a_step_only_in_place_without_hoisted_loads(name, layout):
    """The kernel builds two planes a step only with level 0 in place and no
    hoisted coefficient loads; the layout refuses the rest, and the kernel's
    own choice never asks for them."""
    spec = spec_of(name)
    with pytest.raises(ValueError, match="two planes"):
        tfused.tile_layout(spec, 2, 16, 16, 4, layout=layout, threads=1024,
                           planes=2)
    for tb in (1, 2, 4, 6):
        plan = tfused.choose_tile(spec, tb, 80, 512, 4)
        assert plan.planes == 1 or (plan.layout == "cur-in-place"
                                    and plan.hoist == 0)


@pytest.mark.parametrize("name", NAMES)
def test_mirror_cur_in_place_layout(name):
    """Level 0 read in place from cur, levels 1 ... T-1 in rings."""
    spec = spec_of(name)
    shape = (20, 24, 36)
    state, arrays, scalars = problem(spec, shape, seed=4)
    mirror_vs_plain(spec, state, arrays, scalars, 5, 3, 8, 16,
                    fixed(spec, 16, 16, 4, layout="cur-in-place"))


@pytest.mark.parametrize("name", ["25pt-const", "25pt-var"])
def test_mirror_f64_at_radius_4_takes_the_second_layout(name):
    """f64 at R = 4, t_block = 4: no level-0 ring fits, so the kernel's own
    choice reads level 0 in place."""
    spec = tst.SPECS[name]
    shape = (20, 24, 36)
    plan = tfused.choose_tile(spec, 4, 16, shape[2], 8)
    assert plan.layout == "cur-in-place"
    state, arrays, scalars = problem(spec, shape, dtype="f64", seed=5)
    mirror_vs_plain(spec, state, arrays, scalars, 4, 4, 16, 16,
                    chosen(spec, 16, shape[2], 8))


@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_mirror_reduced_precision_native(dt):
    """Rings hold the stream type: every level rounds as the reference's."""
    spec = tst.SPECS["7pt-var"]
    state, arrays, scalars = problem(spec, GRID, dtype=dt, seed=6)
    mirror_vs_plain(spec, state, arrays, scalars, 4, 4, 16, 16,
                    chosen(spec, 16, GRID[2], 2))


@pytest.mark.parametrize("name", ["25pt-const", "25pt-var"])
def test_mirror_y_sub_tiles_keep_a_long_pass_in_one_launch(name):
    """25-point ops in f32 at t_block = 6: no x tile fits a block of 16 rows,
    so the kernel splits each block into y tiles of 8 and still takes the
    six steps in one launch."""
    spec = tst.SPECS[name]
    shape = (14, 18, 20)
    assert tfused.launch_steps(spec, 6, 16, shape[2], 4) == [6]
    assert tfused.choose_tile(spec, 6, 16, shape[2], 4).ty < 16
    state, arrays, scalars = problem(spec, shape, seed=7)
    mirror_vs_plain(spec, state, arrays, scalars, 6, 6, 16, 16,
                    chosen(spec, 16, shape[2], 4))


@pytest.mark.parametrize("name", ["25pt-const", "25pt-var"])
def test_mirror_tall_blocks_split_into_y_sub_tiles(name):
    """A block of 80 rows at t_block = 4 fits no layout, so the kernel splits
    it into y tiles of 40; on 50 rows the second is ragged. Bitwise."""
    spec = tst.SPECS[name]
    shape = (18, 50, 36)
    assert tfused.choose_tile(spec, 4, 80, shape[2], 4).ty == 40
    state, arrays, scalars = problem(spec, shape, seed=8)
    mirror_vs_plain(spec, state, arrays, scalars, 5, 4, 16, 80,
                    chosen(spec, 80, shape[2], 4))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_mirror_long_pass_splits_into_launches(dt):
    """25pt-var at t_block = 8: no layout holds eight steps in one launch,
    so the pass runs as launches of 6 + 2 (f32) or 5 + 3 (f64), each
    writing the next one's (cur, prev)."""
    spec = tst.SPECS["25pt-var"]
    shape = (16, 20, 24)
    elem = 4 if dt == "f32" else 8
    assert tfused.launch_steps(spec, 8, 16, shape[2], elem) == (
        [6, 2] if dt == "f32" else [5, 3])
    state, arrays, scalars = problem(spec, shape, dtype=dt, seed=9)
    mirror_vs_plain(spec, state, arrays, scalars, 8, 8, 16, 16,
                    chosen(spec, 16, shape[2], elem))


@pytest.mark.parametrize("dt", ["f32", "f64", "bf16", "fp16"])
@pytest.mark.parametrize("name", NAMES)
def test_launch_steps_take_any_t_block(name, dt):
    """Every t_block runs: in one launch where a layout holds it, else in
    launches that each fit and add up to it (t_block above MAX_LEVELS
    included); at by = 128 as at 16."""
    spec = spec_of(name)
    elem = {"f32": 4, "f64": 8, "bf16": 2, "fp16": 2}[dt]
    for by in (16, 128):
        for tb in list(range(1, 13)) + [tfused.MAX_LEVELS + 8]:
            steps = tfused.launch_steps(spec, tb, by, 512, elem)
            assert sum(steps) == tb and max(steps) <= tfused.MAX_LEVELS
            for t in steps:
                assert tfused.choose_tile(spec, t, by, 512, elem).fits
            if len(steps) > 1:
                with pytest.raises(ValueError, match="no x tile fits"):
                    tfused.choose_tile(spec, steps[0] + 1, by, 512, elem)


@pytest.mark.parametrize("t_block", [1, 2, 3, 4])
@pytest.mark.parametrize("dt", ["f32", "f64", "bf16", "fp16"])
@pytest.mark.parametrize("name", NAMES)
def test_chosen_tile_fits_shared_memory(name, dt, t_block):
    """Every op x dtype x t_block <= 4 at bz = by = 16 has a plan within the
    232,448 bytes a block may take (the static tables included), laid out
    without overlap."""
    spec = spec_of(name)
    elem = {"f32": 4, "f64": 8, "bf16": 2, "fp16": 2}[dt]
    plan = tfused.choose_tile(spec, t_block, 16, 512, elem)
    assert plan.fits
    assert plan.smem_bytes + tfused.STATIC_SMEM <= 232_448
    assert plan.threads in (256, 512, 1024) and plan.ctas_per_sm >= 1
    spans = [(0, 4 * plan.tab_ints)]
    for s, q in enumerate(plan.rings):
        if q is None:
            assert s == 0 and plan.layout == "cur-in-place"
            continue
        m = (t_block - s) * spec.radius
        assert q.my == m and q.height == plan.ty + 2 * m
        assert q.mx >= m and q.width >= q.mx + plan.bx + m
        assert q.depth == 2 * spec.radius + plan.planes * (
            1 + tfused.LOAD_AHEAD if s == 0 else 1)
        spans.append((q.base, q.base + q.depth * q.plane * elem))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start and start % 16 == 0
    assert spans[-1][1] <= plan.smem_bytes


def test_no_layout_fits_raises():
    spec = tst.SPECS["25pt-var"]
    with pytest.raises(ValueError, match="no x tile fits"):
        tfused.choose_tile(spec, 8, 16, 512, 8)
    with pytest.raises(ValueError, match="t_block"):
        tfused.choose_tile(spec, tfused.MAX_LEVELS + 1, 16, 512, 4)


@pytest.mark.parametrize("macro,value", [
    ("FUSED_MAX_LEVELS", tfused.MAX_LEVELS),
    ("FUSED_STATIC_SMEM", tfused.STATIC_SMEM),
    ("FUSED_MAX_THREADS", tfused.MAX_THREADS),
    ("FUSED_MAX_PLANES", tfused.MAX_PLANES)])
def test_host_limits_match_the_kernel(macro, value):
    src = (_build.CSRC / "fused.cu").read_text()
    m = re.search(rf"#define {macro} (\d+)", src)
    assert m and int(m.group(1)) == value


def test_geometry_table_matches_the_kernels_reader():
    """`_geometry` writes the head that `read_geo` reads, then 7 ring
    fields per level."""
    src = (_build.CSRC / "fused.cu").read_text()
    head = int(re.search(r"#define FUSED_GEO_HEAD (\d+)", src).group(1))
    spec = tst.SPECS["7pt-var"]
    plan = tfused.choose_tile(spec, 3, 16, 64, 4)
    geo = tfused._geometry(spec, (20, 30, 64), 3, 16, 16, plan)
    assert len(geo) == head + 7 * 3
    assert list(geo[:head][[5, 6, 10]]) == [plan.bx, plan.ty, plan.planes]


def test_window_bound_counts_clipped_boxes():
    """`window_bytes` for one tile that covers the grid: cur, the
    coefficient streams and two outputs, each once."""
    spec = tst.SPECS["7pt-var"]
    shape = (8, 10, 12)
    cells = 8 * 10 * 12
    got = tfused.window_bytes(spec, shape, 2, 8, 10, 12, 4)
    assert got == (cells * (1 + spec.n_coeff_arrays) + 2 * cells) * 4
    # x tiles of 4 at t_block 1: cur's box 1 column wider on inner sides
    got = tfused.window_bytes(tst.SPECS["7pt-const"], shape, 1, 8, 10, 4, 4)
    assert got == (8 * 10 * (5 + 6 + 5) + 2 * cells) * 4
    # y tiles of 4 within the block of 10 rows: 4, 4, 2, each 1 row taller
    # on inner sides
    got = tfused.window_bytes(tst.SPECS["7pt-const"], shape, 1, 8, 10, 12, 4,
                              ty=4)
    assert got == (8 * (5 + 6 + 3) * 12 + 2 * cells) * 4
