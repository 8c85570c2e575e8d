"""K1, K2 and K3 on the card against their plain PyTorch versions.

They skip without a GPU.

Run on a CUDA machine with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports only the port, so it runs where JAX is not installed.
"""

import itertools

import pytest
import torch

from repro_torch.core import ir as tir
from repro_torch.core import stencils as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_fused as tfused
from repro_torch.kernels import stencil_mwd as tkern
from repro_torch.kernels import stencil_sweep as tsweep
from repro_torch.kernels._host import edge_pad


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


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(spec, state, arrays, scalars, n_steps, **kw):
    """Run the kernel and the plain version on identical padded inputs."""
    jobs = [tkern.prepare(spec, state, arrays, scalars, n_steps, **kw)
            for _ in range(2)]
    tkern.run_kernel(jobs[0])
    tkern.run_plain(jobs[1])
    torch.cuda.synchronize()
    return tkern.finish(jobs[0]), tkern.finish(jobs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
@pytest.mark.parametrize("fused", [True, False])
def test_kernel_bitwise_equals_plain_version_f32(cuda, name, fused):
    spec = aniso11(tir) if name == "aniso11" else tst.SPECS[name]
    d_w = 12 if name == "aniso11" else 8
    state, coeffs = tst.make_problem(spec, (24, 40, 36), seed=1, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    got, want = _kernel_vs_plain(spec, state, arrays, scalars, 6, d_w=d_w,
                                 n_f=2, fused=fused)
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_kernel_reduced_precision_equals_plain_version(cuda, dt):
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (24, 40, 36), dtype=dt, seed=2,
                                     device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    for acc in (torch.float32, None):
        got, want = _kernel_vs_plain(spec, state, arrays, scalars, 6, d_w=8,
                                     n_f=2, fused=True, acc_dtype=acc)
        assert_bitwise(got, want)


@pytest.mark.gpu
def test_kernel_batched_equals_per_item_loop(cuda):
    spec = tst.SPECS["25pt-var"]
    probs = [tst.make_problem(spec, (20, 34, 24), seed=s, device=cuda)
             for s in (0, 1)]
    before = tkern.LAUNCHES.count
    cur, prev = tops.mwd_batched(spec, [p[0] for p in probs],
                                 [p[1] for p in probs], 5)
    assert tkern.LAUNCHES.count > before
    for i, (state, coeffs) in enumerate(probs):
        assert_bitwise((cur[i], prev[i]), tops.mwd(spec, state, coeffs, 5))


MID_GRID = (48, 64, 40)
ODD_GRID = (37, 53, 29)
WIDE_GRID = (20, 40, 200)     # x: 2-7 CTAs per tile, by the kernel's choice


def _chosen_vs_plain(spec, state, arrays, scalars, n_steps, **kw):
    """The kernel, as it configures itself, against its plain version on the
    full padded grids; returns the configuration it chose."""
    jobs = [tkern.prepare(spec, state, arrays, scalars, n_steps, **kw)
            for _ in range(2)]
    cfg = tkern.kernel_config(jobs[0])
    tkern.run_kernel(jobs[0])
    tkern.run_plain(jobs[1])
    torch.cuda.synchronize()
    assert_bitwise(jobs[0].bufs, jobs[1].bufs)
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_cluster_kernel_bitwise_equals_plain_version(cuda, name):
    """Several CTAs per tile (halos through distributed shared memory where
    an update pushes them), fused and per-row; MID_GRID and ODD_GRID with
    one CTA per tile."""
    spec = _spec(name)
    d_w = 12 if name == "aniso11" else 8
    state, coeffs = tst.make_problem(spec, WIDE_GRID, seed=1, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    for fused in (True, False):
        cfg = _chosen_vs_plain(spec, state, arrays, scalars, 8, d_w=d_w,
                               n_f=2, fused=fused)
        assert 1 < cfg["cluster"] < 8
        assert cfg["exchange"] == (spec.radius < 4)
    for grid, n_f, n_steps in ((MID_GRID, 2, 8), (ODD_GRID, 4, 5)):
        state, coeffs = tst.make_problem(spec, grid, seed=2, device=cuda)
        arrays, scalars = tir.split_coeffs(spec, coeffs)
        cfg = _chosen_vs_plain(spec, state, arrays, scalars, n_steps,
                               d_w=d_w, n_f=n_f, fused=True)
        assert cfg["cluster"] == 1


@pytest.mark.gpu
def test_cluster_kernel_stages_coefficients_where_they_fit(cuda):
    """At WIDE_GRID the kernel stages 25pt-const's one coefficient stream
    and reads 7pt-var's seven in place; both bitwise."""
    for name, stage in (("25pt-const", 1), ("7pt-var", 0)):
        spec = tst.SPECS[name]
        state, coeffs = tst.make_problem(spec, WIDE_GRID, seed=8,
                                         device=cuda)
        arrays, scalars = tir.split_coeffs(spec, coeffs)
        cfg = _chosen_vs_plain(spec, state, arrays, scalars, 6, d_w=8,
                               n_f=2, fused=True)
        assert cfg["stage"] == stage


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_cluster_kernel_batched_and_f64(cuda, name):
    spec = tst.SPECS[name]
    probs = [tst.make_problem(spec, WIDE_GRID, seed=s, device=cuda)
             for s in (3, 4)]
    state = tuple(torch.stack([p[0][i] for p in probs]) for i in (0, 1))
    arrays = torch.stack([tir.split_coeffs(spec, p[1])[0] for p in probs])
    scalars = tir.split_coeffs(spec, probs[0][1])[1]
    cfg = _chosen_vs_plain(spec, state, arrays, scalars, 8, d_w=8, n_f=2,
                           fused=True)
    assert cfg["cluster"] > 1
    s64, c64 = tst.make_problem(spec, WIDE_GRID, dtype="f64", seed=5,
                                device=cuda)
    a64, sc64 = tir.split_coeffs(spec, c64)
    cfg = _chosen_vs_plain(spec, s64, a64, sc64, 8, d_w=8, n_f=2,
                           fused=True)
    assert cfg["cluster"] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-const", "25pt-var"])
def test_cluster_size_follows_the_x_width(cuda, name):
    """Fewer CTAs than the cluster maximum where x is narrow; 8 at 512."""
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, WIDE_GRID, seed=6, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    cfg = _chosen_vs_plain(spec, state, arrays, scalars, 4, d_w=8, n_f=2,
                           fused=True)
    assert 1 < cfg["cluster"] < 8
    state, coeffs = tst.make_problem(spec, (12, 24, 512), seed=7,
                                     device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    cfg = _chosen_vs_plain(spec, state, arrays, scalars, 2, d_w=8, n_f=2,
                           fused=True)
    assert (cfg["cluster"], cfg["slab"]) == (8, 64)
    assert cfg["max_active_clusters"] >= 1


def _spec(name):
    return aniso11(tir) if name == "aniso11" else tst.SPECS[name]


def _plain_fused(spec, state, arrays, scalars, n_steps, t_block, **kw):
    for tb in tfused.pass_lengths(n_steps, t_block):
        state = tfused.run_plain(spec, state, arrays, scalars, tb, **kw)
    return state


def _baselines_vs_plain(spec, state, coeffs, n_steps, t_block, bz, by):
    """K2 and K3 over n_steps, each beside its plain version."""
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    got_s = tops.spatial(spec, state, coeffs, n_steps, bz=bz)
    want_s = state
    for _ in range(n_steps):
        want_s = tsweep.run_plain(spec, want_s, arrays, scalars)
    got_g = tops.ghostzone(spec, state, coeffs, n_steps, t_block=t_block,
                           bz=bz, by=by)
    want_g = _plain_fused(spec, state, arrays, scalars, n_steps, t_block,
                          bz=bz, by=by)
    torch.cuda.synchronize()
    return (got_s, want_s), (got_g, want_g)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_baseline_kernels_bitwise_equal_plain_versions_f32(cuda, name):
    spec = _spec(name)
    state, coeffs = tst.make_problem(spec, (24, 40, 36), seed=3, device=cuda)
    for got, want in _baselines_vs_plain(spec, state, coeffs, 5, 3, 8, 8):
        assert_bitwise(got, want)
    naive = tops.naive(spec, state, coeffs, 5)
    assert_bitwise(tops.spatial(spec, state, coeffs, 5), naive)
    assert_bitwise(tops.ghostzone(spec, state, coeffs, 5), naive)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_baseline_kernels_native_bf16_equal_plain_versions(cuda, name):
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, (24, 40, 36), dtype="bf16",
                                     seed=4, device=cuda)
    for got, want in _baselines_vs_plain(spec, state, coeffs, 4, 3, 8, 8):
        assert got[0].dtype == torch.bfloat16
        assert_bitwise(got, want)


@pytest.mark.gpu
def test_baseline_kernels_nonmultiple_grid_and_launch_counts(cuda):
    spec = tst.SPECS["7pt-const"]
    state, coeffs = tst.make_problem(spec, (37, 53, 29), seed=5, device=cuda)
    before = (tsweep.LAUNCHES.count, tfused.LAUNCHES.count)
    for got, want in _baselines_vs_plain(spec, state, coeffs, 5, 3, 8, 8):
        assert_bitwise(got, want)
    assert tsweep.LAUNCHES.count == before[0] + 5
    assert tfused.LAUNCHES.count == before[1] + 2


def _fused_vs_plain(spec, state, coeffs, n_steps, t_block, **kw):
    """K3 over n_steps (short last pass where t_block does not divide it)
    against its plain version; returns the configuration of the first pass."""
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    cfg = tfused.kernel_config(spec, state[0], t_block, **kw)
    got = tops.ghostzone(spec, state, coeffs, n_steps, t_block=t_block, **kw)
    want = _plain_fused(spec, state, arrays, scalars, n_steps, t_block, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("t_block", [1, 2, 4])
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_fused_kernel_t_blocks_and_ragged_x_tiles(cuda, name, t_block):
    """The kernel's own x tile leaves a narrower last tile at nx = 204;
    bz = by = 16 divide neither nz nor ny; 7 steps end in a short pass."""
    spec = _spec(name)
    state, coeffs = tst.make_problem(spec, (20, 40, 204), seed=9,
                                     device=cuda)
    cfg = _fused_vs_plain(spec, state, coeffs, 7, t_block)
    assert 204 % cfg["bx"] and cfg["resident"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_fused_kernel_f64_and_odd_grid(cuda, name):
    """f64 at t_block = 4 (at R = 4 no level-0 ring fits, so level 0 is
    read in place) and a grid no tile divides."""
    spec = _spec(name)
    state, coeffs = tst.make_problem(spec, (24, 40, 36), dtype="f64",
                                     seed=10, device=cuda)
    cfg = _fused_vs_plain(spec, state, coeffs, 5, 4)
    if spec.radius == 4:
        assert cfg["layout"] == "cur-in-place"
    state, coeffs = tst.make_problem(spec, ODD_GRID, seed=11, device=cuda)
    _fused_vs_plain(spec, state, coeffs, 5, 3)
    assert_bitwise(tops.ghostzone(spec, state, coeffs, 5, t_block=3),
                   tops.naive(spec, state, coeffs, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
@pytest.mark.parametrize("name", list(tst.SPECS))
def test_fused_kernel_native_reduced_precision(cuda, name, dt):
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, (24, 40, 72), dtype=dt, seed=12,
                                     device=cuda)
    _fused_vs_plain(spec, state, coeffs, 6, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("dt,t_block,by,n_steps", [
    ("f32", 6, 16, 7), ("f32", 4, 80, 5), ("f32", 8, 16, 8),
    ("f64", 8, 16, 8)])
@pytest.mark.parametrize("name", ["25pt-const", "25pt-var"])
def test_fused_kernel_y_sub_tiles_and_split_passes(cuda, name, dt, t_block,
                                                   by, n_steps):
    """Where no layout holds a block of by rows the kernel splits it into y
    tiles; where none holds the pass, it runs as launches of fewer steps."""
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, (24, 50, 40), dtype=dt, seed=13,
                                     device=cuda)
    elem = state[0].element_size()
    before = tfused.LAUNCHES.count
    cfg = _fused_vs_plain(spec, state, coeffs, n_steps, t_block, by=by)
    assert cfg["ty"] < by
    assert cfg["launches"] == tfused.launch_steps(spec, t_block, by, 40, elem)
    assert tfused.LAUNCHES.count - before == sum(
        len(tfused.launch_steps(spec, tb, by, 40, elem))
        for tb in tfused.pass_lengths(n_steps, t_block))


def _sweep_vs_plain(spec, state, coeffs, n_steps, bz):
    """K2 over n_steps (ops.spatial) against its plain version, bitwise;
    returns the launch configuration and the launches counted."""
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    cfg = tsweep.kernel_config(spec, state[0], bz=bz)
    before = tsweep.LAUNCHES.count
    got = tops.spatial(spec, state, coeffs, n_steps, bz=bz)
    launched = tsweep.LAUNCHES.count - before
    want = state
    for _ in range(n_steps):
        want = tsweep.run_plain(spec, want, arrays, scalars)
    torch.cuda.synchronize()
    assert_bitwise(got, want)
    return cfg, launched


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "f64", "bf16", "fp16"])
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_sweep_kernel_tiling_edges(cuda, name, dt):
    """K2 where its tiling has edges, in every stream type: ODD_GRID (no
    tile divides ny or nx; nx = 29 leaves rows unaligned) at bz = 1, 3 (a
    chunk that does not divide nz) and 64 (> nz), and WIDE_GRID."""
    spec = _spec(name)
    for grid, bz, n_steps in ((ODD_GRID, 1, 2), (ODD_GRID, 3, 3),
                              (ODD_GRID, 64, 2), (WIDE_GRID, 8, 3)):
        state, coeffs = tst.make_problem(spec, grid, dtype=dt, seed=14,
                                         device=cuda)
        cfg, launched = _sweep_vs_plain(spec, state, coeffs, n_steps, bz)
        assert launched == n_steps and cfg["chunk"] % bz == 0
        assert cfg["resident"] >= 1 and cfg["copy"] != "in-place"
        if grid == ODD_GRID:
            assert grid[1] % cfg["ty"] and grid[2] % cfg["tx"]
            assert cfg["copy"] == "cp.async"


@pytest.mark.gpu
@pytest.mark.parametrize("copy", tsweep.COPIES)
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_sweep_kernel_copy_paths(cuda, name, copy, monkeypatch):
    """The ring and the in-place path, with and without the L2 prefetch of
    the streams, at a tile of 128 columns by the most rows up to 8 that fit
    and a chunk of 5 planes, on a 200-wide grid; f32 and f64."""
    spec = _spec(name)
    for dt, prefetch in itertools.product(("f32", "f64"), (0, 2)):
        state, coeffs = tst.make_problem(spec, (21, 26, 200), dtype=dt,
                                         seed=15, device=cuda)
        plan = next(p for ty in (8, 4, 2, 1) for p in [tsweep.tile_layout(
            spec, ty, 128, state[0].element_size(), threads=128, chunk=5,
            copy=copy, prefetch=prefetch)] if p.fits)
        monkeypatch.setattr(tsweep, "choose_tile", lambda *a, p=plan: p)
        cfg, _ = _sweep_vs_plain(spec, state, coeffs, 2, 5)
        assert cfg["copy"] == copy and cfg["chunk"] == 5
        assert cfg["prefetch"] == plan.prefetch


@pytest.mark.gpu
def test_sweep_kernel_large_radius_reads_in_place(cuda):
    """A radius no ring fits takes the in-place instance."""
    taps = (tir.Tap(0, 0, 0, tir.const(0)), tir.Tap(40, 0, 0, tir.const(1)),
            tir.Tap(-40, 0, 0, tir.const(1)), tir.Tap(0, 0, 40, tir.const(1)))
    spec = tir.StencilOp("far", taps, default_scalars=(0.5, 0.25))
    state, coeffs = tst.make_problem(spec, (82, 81, 84), dtype="f64",
                                     seed=16, device=cuda)
    cfg, _ = _sweep_vs_plain(spec, state, coeffs, 2, 8)
    assert cfg["copy"] == "in-place"


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_fit_twin_equals_kernel_config(cuda, name):
    """models.mwd_smem_plan, the machine model's twin of K1's launch choice,
    against the kernel's own on every width up to the first that fits no
    more: equal where it fits, E_SMEM where it does not."""
    from repro_torch.core import models
    spec = _spec(name)
    r = spec.radius
    keys = ("cluster", "slab", "stage", "threads", "smem_bytes", "depth",
            "cdepth")
    for dt, word in (("f32", 4), ("f64", 8)):
        for nx in (40, 200):
            state, coeffs = tst.make_problem(spec, (2 * r + 4, 2 * r + 4, nx),
                                             dtype=dt, seed=0, device=cuda)
            arrays, scalars = tir.split_coeffs(spec, coeffs)
            d_w, twins = 2 * r, [True]
            while any(twins):
                twins = []
                for n_f in (n for n in (1, 2, 4) if d_w % n == 0):
                    twin = models.mwd_smem_plan(spec, d_w, n_f, nx, word)
                    twins.append(twin)
                    job = tkern.prepare(spec, state, arrays, scalars, 2,
                                        d_w=d_w, n_f=n_f, fused=True)
                    if twin is None:
                        with pytest.raises(RuntimeError, match=r"\(-5\)"):
                            tkern.kernel_config(job)
                    elif twin.per_sm:
                        cfg = tkern.kernel_config(job)
                        assert {k: cfg[k] for k in keys} == \
                            {k: getattr(twin, k) for k in keys}
                d_w += 2 * r


# F3: plans whose rings fit the opt-in limit alone but not beside the
# block's static shared memory; K1 once refused them at launch, and now
# takes the next cluster size (op, dtype, columns, d_w, n_f)
STATIC_SMEM_CASES = [("7pt-const", "f32", 40, 32, 1),
                     ("7pt-var", "f32", 200, 32, 1),
                     ("7pt-const", "f32", 512, 16, 4),
                     ("25pt-var", "f32", 40, 32, 4),
                     ("25pt-const", "f64", 512, 8, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dt,nx,d_w,n_f", STATIC_SMEM_CASES)
def test_kernel_takes_plans_beside_its_static_shared_memory(cuda, name, dt,
                                                            nx, d_w, n_f):
    """K1 launches at the fit twin's plan (a larger cluster than the rings
    alone would take) and equals its plain version bitwise."""
    import dataclasses
    from repro_torch.core import models, specs
    spec = tst.SPECS[name]
    word = 8 if dt == "f64" else 4
    chip = specs.current_spec()
    twin = models.mwd_smem_plan(spec, d_w, n_f, nx, word)
    alone = models.mwd_smem_plan(spec, d_w, n_f, nx, word, dataclasses.replace(
        chip, smem_block_bytes=chip.smem_block_bytes
        + models.MWD_STATIC_SMEM))
    assert twin.cluster > alone.cluster
    state, coeffs = tst.make_problem(spec, (4 * spec.radius + 8, 24, nx),
                                     dtype=dt, seed=5, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    jobs = [tkern.prepare(spec, state, arrays, scalars, 4, d_w=d_w, n_f=n_f,
                          fused=True) for _ in range(2)]
    cfg = tkern.kernel_config(jobs[0])
    assert (cfg["cluster"], cfg["slab"], cfg["smem_bytes"]) == (
        twin.cluster, twin.slab, twin.smem_bytes)
    assert cfg["static_smem"] == models.MWD_STATIC_SMEM
    tkern.run_kernel(jobs[0])
    tkern.run_plain(jobs[1])
    torch.cuda.synchronize()
    for a, b in zip(jobs[0].bufs, jobs[1].bufs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_measured_tune_one_on_a_small_grid(cuda, tmp_path, monkeypatch):
    """tune_one times whole ops.mwd calls on the card, persists the winner,
    and a second run measures nothing; plan="auto" then resolves it."""
    from repro_torch.core import registry
    from repro_torch.launch import tune
    monkeypatch.setenv(registry.ENV_VAR, str(tmp_path / "plans.json"))
    spec, grid = tst.SPECS["7pt-var"], (16, 40, 64)
    reg = registry.default_registry()
    first = tune.tune_one(spec, grid, reg, max_evals=4, reps=2, n_steps=4,
                          device=cuda)
    assert first["source"] == "measured" and first["measurements"] > 0
    second = tune.tune_one(spec, grid, reg, max_evals=4, reps=2, n_steps=4,
                           device=cuda)
    assert (second["source"], second["measurements"]) == ("cached", 0)
    plan, source = registry.resolve_plan(spec, grid)
    assert (plan, source) == (first["plan"], "registry:measured")
    state, coeffs = tst.make_problem(spec, grid, seed=3, device=cuda)
    assert_bitwise(tops.mwd(spec, state, coeffs, 4, plan="auto"),
                   tops.mwd(spec, state, coeffs, 4, d_w=plan.d_w,
                            n_f=plan.n_f, fused=plan.fused))


def mixed(irmod):
    """A 2nd-order op with const and array taps and a const scale (the
    reference adjoint test's op)."""
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


def _op(name):
    return {"aniso11": aniso11, "adj-mixed": mixed}.get(
        name, lambda _: tst.SPECS[name])(tir)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11", "adj-mixed"])
@pytest.mark.parametrize("fused", [True, False])
def test_kernel_on_the_adjoint_op_bitwise(cuda, name, fused):
    """K1 on `ir.adjoint(op).op` with the transported streams: 25 array
    groups at the 25-point ops (past the largest hoist, 16), 2nd order
    without a scale at 25pt-const.T, negated asymmetric taps at aniso11 and
    adj-mixed; the launch choice equals the fit twin's."""
    from repro_torch.core import models
    spec = _op(name)
    adj = tir.adjoint(spec)
    d_w = 12 if spec.radius == 3 else 8
    state, coeffs = tst.make_problem(spec, (24, 40, 36), seed=4, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    adj_arrays, adj_scalars = adj.map_coeffs(arrays, scalars)
    job = tkern.prepare(adj.op, state, adj_arrays, adj_scalars, 4, d_w=d_w,
                        n_f=2, fused=fused)
    cfg = tkern.kernel_config(job)
    twin = models.mwd_smem_plan(adj.op, d_w, 2, 36)
    assert {k: cfg[k] for k in ("cluster", "slab", "stage", "threads",
                                "smem_bytes")} == {
        k: getattr(twin, k) for k in ("cluster", "slab", "stage", "threads",
                                      "smem_bytes")}
    got, want = _kernel_vs_plain(adj.op, state, adj_arrays, adj_scalars, 4,
                                 d_w=d_w, n_f=2, fused=fused)
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const", "adj-mixed"])
def test_mwd_diff_gradients_match_autograd_through_naive(cuda, name):
    """The backward runs K1 on the adjoint op (launches counted) and matches
    autograd through `ops.naive` within ``8·(atol + rtol·max(|ref|, 1))``;
    the 1st-order stacked forward equals the fused advance bitwise."""
    spec = _op(name)
    grid = (20, 24, 36) if spec.radius == 1 else (24, 32, 40)
    state, coeffs = tst.make_problem(spec, grid, seed=5, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    w = torch.randn(grid, generator=torch.Generator(cuda).manual_seed(1),
                    device=cuda)

    def grads(runner, **kw):
        args = [t.clone().requires_grad_()
                for t in (state[0], state[1], arrays)]
        out = runner(spec, (args[0], args[1]),
                     tir.join_coeffs(spec, args[2], scalars), 4, **kw)
        return out, torch.autograd.grad((w * out[0]).sum(), args,
                                        allow_unused=True)

    before = tkern.LAUNCHES.count
    out, got = grads(tops.mwd_diff, d_w=8, n_f=2)
    assert tkern.LAUNCHES.count > before
    assert_bitwise(out, tops.mwd(spec, state, coeffs, 4, d_w=8, n_f=2))
    _, want = grads(tops.naive)
    atol, rtol = spec.tolerance("f32")
    for a, b in zip(got, want):
        b = torch.zeros_like(a) if b is None else b
        mag = max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= 8 * (atol + rtol * mag)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-var", "7pt-const", "25pt-const"])
def test_ragged_server_equals_per_request_mwd(cuda, name):
    """Two grid sizes in one pow2 class (64^3), batches of one exact and
    one smaller member: every batch takes the masked path through K1, and
    each response equals its own unpadded `ops.mwd` bitwise."""
    from repro_torch.core.mwd import MWDPlan
    from repro_torch.launch import serve
    plan = MWDPlan(d_w=8, n_f=2)
    before = tkern.LAUNCHES.count
    rep = serve.serve_stencil(name, [(64, 64, 64), (48, 60, 52)], n_steps=6,
                              n_requests=4, max_batch=2, pad="pow2",
                              plan=plan, device=cuda)
    assert tkern.LAUNCHES.count > before
    assert rep["batch_sizes"] == [2, 2] and rep["classes"] == {
        str((64, 64, 64)): 4}
    for req in rep["requests"]:
        want = tops.mwd(req.spec, req.state, req.coeffs, 6, plan=plan)
        assert_bitwise(rep["results"][req.rid], want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_every_host_wait_in_mwd_is_a_sync_span(cuda, name):
    """The waits on the device that torch's sync debug mode reports inside
    `ops.mwd` are the calls' ``girih.sync`` spans, one for one, and K1's
    host-side spans nest in the calls' ``girih.mwd``."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trace
    from repro_torch.core.mwd import MWDPlan
    spec, plan = tst.SPECS[name], MWDPlan(d_w=8, n_f=2)
    state, coeffs = tst.make_problem(spec, (64, 72, 80), seed=0, device=cuda)
    tops.mwd(spec, state, coeffs, 8, plan=plan)          # build and warm
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(2):
                    tops.mwd(spec, state, coeffs, 8, plan=plan)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    warned = [w for w in seen
              if "called a synchronizing CUDA operation" in str(w.message)]
    calls = trace.spans("girih.mwd")
    syncs = [s for s in trace.spans("girih.sync") if s.under("girih.mwd")]
    assert len(calls) == 2 and len(syncs) == len(warned) >= 2
    for step in ("girih.mwd.prepare", "girih.mwd.tables",
                 "girih.mwd.launch", "girih.mwd.finish"):
        assert [s.under("girih.mwd") for s in trace.spans(step)] == calls


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-const", "aniso11"])
@pytest.mark.parametrize("batched", [False, True])
def test_kernel_on_mask_twins_equals_plain_version(cuda, name, batched):
    """K1 on the +mask twins (7pt-const's 2 streams, aniso11's 6) on their
    padded problems, fused and per-row, one member or B = 2."""
    from repro_torch.core import padding
    spec = aniso11(tir) if name == "aniso11" else tst.SPECS[name]
    d_w = 12 if name == "aniso11" else 8
    probs = [tst.make_problem(spec, sh, seed=s, device=cuda)
             for s, sh in enumerate([(40, 56, 36), (48, 64, 40)])]
    members = probs if batched else probs[:1]
    mop, state, packed = padding.pad_batch(
        spec, [p[0] for p in members], [p[1] for p in members], (64, 64, 64))
    arrays, scalars = tir.split_coeffs(mop, packed)
    assert mop.name == f"{name}+mask"
    if not batched:
        state, arrays = (state[0][0], state[1][0]), arrays[0]
    for fused in (True, False):
        got, want = _kernel_vs_plain(mop, state, arrays, scalars, 6,
                                     d_w=d_w, n_f=2, fused=fused)
        assert_bitwise(got, want)


def _dist_mesh(cuda):
    from repro_torch.launch import mesh as tmesh
    return tmesh.make_debug_mesh((2, 2), devices=[cuda] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS))
@pytest.mark.parametrize("block", ["corner", "z_lo", "y_hi"])
def test_kernel_on_shard_blocks_equals_plain_version(cuda, name, block):
    """K1 on a 2x2 mesh's shard shapes: a corner shard's extended block and
    zone slabs 3g thick, with the runtime interior and ``y_domain = (0,
    bny)`` the distributed stepper gives it."""
    from repro_torch.core.mwd import MWDPlan
    from repro_torch.distributed import stepper
    spec = tst.SPECS[name]
    grid = (64, 64, 40)
    g = 2 * spec.radius
    part = stepper.partition_geometry((32, 32, 40), g, True, True)
    ext = (32 + 2 * g, 32 + 2 * g, 40 + 2 * g)
    state, coeffs = tst.make_problem(spec, ext, seed=4, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    zs, ys, origin = slice(None), slice(None), (-g, -g)
    if block != "corner":
        zn = next(z for z in part.zones if z.name == block)
        zs, ys, origin = zn.z, zn.y, zn.origin
    a, b = (t[zs, ys].contiguous() for t in state)
    arr = arrays[:, zs, ys].contiguous() if arrays is not None else None
    plan = stepper.cap_plan_d_w(spec, MWDPlan(d_w=8, n_f=2), a.shape[1])
    got, want = _kernel_vs_plain(
        spec, (a, b), arr, scalars, 2, d_w=plan.d_w, n_f=plan.n_f,
        fused=True,
        interior=stepper.block_interior(spec, grid, g, a.shape, origin),
        y_domain=(0, a.shape[1]))
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS))
def test_distributed_k1_route_equals_naive(cuda, name):
    """run_distributed on four shards of one card, K1 per shard, both
    schedules, a trailing partial super-step: bitwise equal to ops.naive;
    compressed halos within the reference's 5e-2."""
    from repro_torch.core.mwd import MWDPlan
    from repro_torch.distributed import stepper
    spec = tst.SPECS[name]
    grid = (48, 48, 40) if spec.radius == 1 else (72, 72, 40)
    state, coeffs = tst.make_problem(spec, grid, seed=6, device=cuda)
    mesh = _dist_mesh(cuda)
    plan = MWDPlan(d_w=2 * spec.radius * 2, n_f=2)
    want = tops.naive(spec, state, coeffs, 5)
    before = tkern.LAUNCHES.count
    for ovl in (False, True):
        got = stepper.run_distributed(spec, mesh, state, coeffs, 5, 2,
                                      plan=plan, overlap=ovl)
        torch.cuda.synchronize()
        assert_bitwise(got, want)
    assert tkern.LAUNCHES.count > before
    lossy = stepper.run_distributed(spec, mesh, state, coeffs, 4, 2,
                                    plan=plan, compress=True, overlap=True)
    exact = tops.naive(spec, state, coeffs, 4)
    err = float((lossy[0] - exact[0]).abs().max())
    assert 0.0 < err < 5e-2


@pytest.mark.gpu
def test_halo_exchange_copies_on_one_card(cuda):
    """On one card the exchange still copies: every receive buffer is new
    storage, written on the communication stream, equal to the slab."""
    from repro_torch.distributed import halo
    x = torch.randn((16, 12, 8), device=cuda)
    blocks = [x[:8].contiguous(), x[8:].contiguous()]
    parts = halo.exchange_axis_parts(blocks, 0, 3)
    torch.cuda.synchronize()
    lo = parts[1][0]
    assert lo.data_ptr() != blocks[0].data_ptr()
    assert not (blocks[0].data_ptr() <= lo.data_ptr()
                < blocks[0].data_ptr() + blocks[0].numel() * 4)
    assert torch.equal(lo, blocks[0][-3:])
    ext = halo.exchange_2d([[b] for b in blocks], 2)
    torch.cuda.synchronize()
    want = edge_pad(blocks[0][-2:], ((0, 0), (2, 2), (0, 0)))
    assert torch.equal(ext[1][0][:2], want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_requested_cluster_sizes_bitwise_equal_plain_version(cuda, name):
    """K1 at every cluster size it takes at WIDE_GRID (the paper's
    thread-group size, `prepare(cluster=)`): bitwise equal to the plain
    version, its configuration the fit twin's at that size; a size the
    twin refuses raises `LaunchRefused` (E_SMEM or E_CLUSTER_SIZE)."""
    from repro_torch.core import models
    spec = _spec(name)
    d_w = 12 if spec.radius == 3 else 8
    kw = dict(d_w=d_w, n_f=2, fused=True)
    state, coeffs = tst.make_problem(spec, WIDE_GRID, seed=3, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    plain = tkern.prepare(spec, state, arrays, scalars, 5, **kw)
    tkern.run_plain(plain)
    keys = ("cluster", "slab", "stage", "threads", "smem_bytes")
    taken = []
    for c in range(1, tkern.MAX_CLUSTER + 1):
        twin = models.mwd_smem_plan(spec, d_w, 2, WIDE_GRID[2], cluster=c)
        job = tkern.prepare(spec, state, arrays, scalars, 5, cluster=c, **kw)
        if twin is None:
            with pytest.raises(tkern.LaunchRefused) as refused:
                tkern.kernel_config(job)
            assert refused.value.code in ("E_SMEM", "E_CLUSTER_SIZE")
            continue
        cfg = tkern.kernel_config(job)
        assert {k: cfg[k] for k in keys} == {k: getattr(twin, k)
                                             for k in keys}
        tkern.run_kernel(job)
        torch.cuda.synchronize()
        assert_bitwise(job.bufs, plain.bufs)
        taken.append(c)
    assert len(taken) >= 2


@pytest.mark.gpu
@pytest.mark.parametrize("name,d_w,n_f,cluster,code", [
    ("25pt-var", 8, 4, 1, "E_SMEM"),            # slab 512: rings too large
    ("7pt-const", 4, 4, 1, "E_SMEM"),
    ("7pt-const", 4, 4, 14, "E_CLUSTER_SIZE"),  # 40-column slabs: 13 CTAs
    ("25pt-var", 8, 4, 15, "E_CLUSTER_SIZE"),   # 36-column slabs: 14 CTAs
])
def test_requested_cluster_refusals(cuda, name, d_w, n_f, cluster, code):
    """The kernel never swaps a requested size for another: it refuses."""
    from repro_torch.core import models
    spec = tst.SPECS[name]
    assert models.mwd_smem_plan(spec, d_w, n_f, 512, cluster=cluster) is None
    state, coeffs = tst.make_problem(spec, (2 * spec.radius + 8, 24, 512),
                                     seed=0, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    job = tkern.prepare(spec, state, arrays, scalars, 2, d_w=d_w, n_f=n_f,
                        fused=True, cluster=cluster)
    before = tkern.LAUNCHES.count
    with pytest.raises(tkern.LaunchRefused, match=code) as refused:
        tkern.run_kernel(job)
    assert refused.value.code == code and tkern.LAUNCHES.count == before


GATED_BENCHES = ("smoke", "custom_stencil", "batched_serving",
                 "tuned_vs_default", "adjoint_fit", "fig16_18_groupsize")


@pytest.mark.gpu
@pytest.mark.parametrize("name", GATED_BENCHES)
def test_bench_gates_hold_on_the_card_at_small_sizes(cuda, name, tmp_path,
                                                     monkeypatch):
    """The harness's gates with K1 on the card, at the reference's sizes
    (the groupsize bench's K1 leg at 64^3, each size bitwise)."""
    import dataclasses
    from repro_torch.benchmarks import run as tbench
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    b = tbench.Bench(cuda, echo=False)
    b.sizes = dataclasses.replace(tbench.REFERENCE, clusters=(),
                                  groupsize_k1=64)
    tbench.BENCHES[name](b)
    assert b.rows and all(r.derived.endswith(
        f"device={torch.cuda.get_device_name(cuda)}") for r in b.rows)
    if name == "fig16_18_groupsize":
        k1 = [r for r in b.rows if ".k1." in r.name]
        assert sum(r.data["fits"] for r in k1) >= 2
        assert all(r.data["bitwise"] for r in k1 if r.data["fits"])


# ---------------------------------------------------------------------------
# the LM training path (chip_smoke.py phase 10 at reduced size): no stencil
# kernel runs here; the card's matmuls against the same steps on the CPU
# ---------------------------------------------------------------------------

def _lm_cfg(arch, **kw):
    import dataclasses
    from repro_torch import configs as tc
    return dataclasses.replace(tc.reduced(tc.get(arch)), dtype="float32",
                               **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "mamba2-130m",
                                  "mixtral-8x7b", "jamba-1.5-large-398b"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training import steps
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch)
    params = tree_init(lm.param_specs(cfg), seed=1, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                         dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), params)
        opt, train = steps.make_train_step(cfg, chunk=16)
        state = {"params": p, "opt": opt.init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        out[str(dev)] = train(state, batch)[1]
    got, want = out[str(cuda)], out["cpu"]
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * max(
            1.0, abs(float(want[k]))), k


@pytest.mark.gpu
def test_lm_launcher_resumes_on_the_card(cuda, tmp_path):
    import shutil
    from repro_torch.launch import train
    args = ["--device", "cuda", "--steps", "4", "--batch", "2", "--seq",
            "64", "--ckpt-every", "2"]
    straight, resumed = [], []
    train.main(args + ["--ckpt", str(tmp_path / "a")], records=straight)
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    train.main(args + ["--ckpt", str(tmp_path / "b")], records=resumed)
    assert [r["step"] for r in resumed] == [2, 3]
    for a, b in zip(straight[2:], resumed):
        assert abs(a["loss"] - b["loss"]) <= 1e-3 * abs(a["loss"])
    assert all(torch.isfinite(torch.tensor(r["loss"])) for r in straight)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "mamba2-130m"])
def test_lm_decode_matches_forward_on_the_card(cuda, arch):
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch, n_layers=4)
    params = tree_init(lm.param_specs(cfg), seed=5, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.int32).to(cuda)
    with torch.no_grad():
        want, _ = lm.forward(cfg, params, {"tokens": toks}, chunk=8)
        cache = lm.init_cache(cfg, 1, 24, device=cuda)
        got = []
        for t in range(24):
            lg, cache = lm.decode_step(cfg, params, cache, toks[:, t:t + 1])
            got.append(lg)
    got = torch.cat(got, dim=1)
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the LM serving path (chip_smoke.py phase 11 at reduced size)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "mamba2-130m"])
def test_lm_serve_ids_repeat_on_the_card(cuda, arch):
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "24",
            "--gen", "8"]
    first, second = serve.main(argv), serve.main(argv)
    ids, vocab = first["ids"], first["cfg"].vocab_size
    assert tuple(ids.shape) == (4, 8)
    assert int(ids.min()) >= 0 and int(ids.max()) < vocab
    assert torch.equal(second["ids"], ids)
    assert first["params"]["embed"].device.type == "cuda"
    assert first["tokens_per_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "mamba2-130m"])
def test_lm_prefill_matches_forward_on_the_card(cuda, arch):
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_cfg(arch)
    params = tree_init(lm.param_specs(cfg), seed=5, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 32),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32).to(cuda)
    with torch.no_grad():
        want, _ = lm.forward(cfg, params, {"tokens": toks})
        got, _ = serve.prefill_into_cache(cfg, params, toks, 1)
    want = want[:, -1:]
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_lm_place_allocates_the_local_bytes_on_the_card(cuda, arch):
    from repro_torch import configs as tc
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import tree_sds
    from repro_torch.optim.optimizers import tree_map, tree_paths
    from repro_torch.training import sharding as shd
    dev = torch.device("cuda", 0)
    specs = lm.param_specs(tc.reduced(tc.get(arch)))
    mesh = make_debug_mesh((1, 1), devices=[dev])
    shards = shd.param_shardings(mesh, specs)
    sds = tree_sds(specs)
    want = shd.local_bytes(sds, shards)
    host = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), sds)

    def requested():
        torch.cuda.synchronize()
        return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]

    before = requested()
    placed = shd.place(host, shards)
    assert requested() - before == want
    assert all(t.device == dev for _, t in tree_paths(placed))


@pytest.mark.gpu
def test_two_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on cuda:0 with two shards each (a 2x2 process mesh,
    z across the ranks), 64^3 7pt-var, K1 per shard at plan="auto",
    synchronous and overlapped: bitwise equal to ops.naive, K1 launched
    on both ranks."""
    import _mp_ranks
    from repro_torch.distributed import process
    out = process.launch(_mp_ranks.card2, 2, (str(tmp_path / "plans.json"),),
                         timeout_s=300)
    assert out[0][False] and out[0][True]
    assert all(r["launches"] > 0 for r in out)


@pytest.mark.gpu
def test_lm_sharded_step_on_two_ranks_sharing_the_card(cuda):
    """Two gloo ranks on cuda:0, the reduced llama step on a (1, 2) mesh
    (heads, MLP and vocab over 'model') in float32, against the
    one-process step on the card: step 0's metrics and the next loss
    within 1e-4 x max(1, |ref|), the new parameters within 1e-5 of each
    leaf's norm."""
    import _mp_lm_ranks
    from repro_torch.distributed import process
    out = process.launch(_mp_lm_ranks.card2, 2, (), timeout_s=300)
    (got, want), (l1, w1) = out[0]["metrics"], out[0]["loss1"]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), k
    assert abs(l1 - w1) <= 1e-4 * max(1.0, abs(w1))
    assert out[0]["params_rel"] <= 1e-5


@pytest.mark.gpu
def test_moe_and_mamba_sharded_on_two_ranks_sharing_the_card(cuda):
    """Two gloo ranks on cuda:0, (1, 2) mesh, float32: reduced mixtral
    (experts over 'model') and mamba2 (heads over 'model'), their train
    step's metrics and next loss within 1e-4 x max(1, |ref|) of the
    one-process step on the card, the new parameters within 1e-5 of each
    leaf's norm, and `serve_lm`'s ids equal to one process's."""
    import _mp_lm_ranks
    from repro_torch.distributed import process
    out = process.launch(_mp_lm_ranks.card2_moe_ssm, 2, (), timeout_s=300)
    for arch, got in out[0].items():
        (m, want), (l1, w1) = got["metrics"], got["loss1"]
        for k in want:
            assert abs(m[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), \
                (arch, k)
        assert abs(l1 - w1) <= 1e-4 * max(1.0, abs(w1)), arch
        assert got["params_rel"] <= 1e-5, arch
    for rank in out:
        for arch, got in rank.items():
            sharded, one = got["ids"]
            assert sharded.tolist() == one.tolist(), arch


# ---------------------------------------------------------------------------
# K1's star instances (compile-time taps) against the plain version
# ---------------------------------------------------------------------------

# the plans the benchmark's solves resolve at 512^3 f64: (d_w, n_f)
SOLVE_PLANS = [(8, 2), (4, 4)]


def _star_vs_plain(spec, state, arrays, scalars, n_steps, **kw):
    """The kernel against its plain version, both results; asserts the
    launches all ran a star instance."""
    star0, k1 = tkern.STAR_LAUNCHES.count, tkern.LAUNCHES.count
    got, want = _kernel_vs_plain(spec, state, arrays, scalars, n_steps, **kw)
    launched = tkern.LAUNCHES.count - k1
    assert launched > 0
    assert tkern.STAR_LAUNCHES.count - star0 == launched
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("d_w,n_f", SOLVE_PLANS)
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("name", list(tst.SPECS))
def test_star_kernel_bitwise_equals_plain_version(cuda, name, dt, d_w, n_f):
    """Each paper op in its star instance at the solves' two plans, fused
    and per-row, on a 512-wide grid (the solves' clusters and slabs)
    and a narrow odd one."""
    from repro_torch.kernels import _host
    spec = tst.SPECS[name]
    if d_w % (2 * spec.radius):
        d_w, n_f = 8, 1
    assert _host.star_layout(spec) > 0
    for grid in ((2 * spec.radius + 6, 20, 512), (13, 27, 21)):
        state, coeffs = tst.make_problem(spec, grid, dtype=dt, seed=11,
                                         device=cuda)
        arrays, scalars = tir.split_coeffs(spec, coeffs)
        results = [_star_vs_plain(spec, state, arrays, scalars, 6, d_w=d_w,
                                  n_f=n_f, fused=fused)
                   for fused in (True, False)]
        for got, want in results:
            assert_bitwise(got, want)
        assert_bitwise(results[0][0], results[1][0])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(tst.SPECS))
def test_star_kernel_batched_equals_per_item_loop(cuda, name):
    """B = 2 in one launch per row, bitwise equal to two single runs, f64."""
    spec = tst.SPECS[name]
    probs = [tst.make_problem(spec, (20, 24, 40), dtype="f64", seed=s,
                              device=cuda) for s in (12, 13)]
    splits = [tir.split_coeffs(spec, p[1]) for p in probs]
    state = tuple(torch.stack([p[0][i] for p in probs]) for i in (0, 1))
    arrays = (torch.stack([a for a, _ in splits])
              if spec.n_coeff_arrays else None)
    star0 = tkern.STAR_LAUNCHES.count
    got = tkern.mwd_run_batched(spec, state, arrays, splits[0][1], 5)
    assert tkern.STAR_LAUNCHES.count > star0
    for b, (p, (a, sc)) in enumerate(zip(probs, splits)):
        one = tkern.mwd_run(spec, p[0], a, sc, 5)
        assert_bitwise([g[b] for g in got], one)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["7pt-const", "7pt-var"])
def test_star_kernel_on_masked_twin_and_adjoint(cuda, name):
    """The 7-point +mask twin (7pt-const's: its groups turned to streams,
    a layout of its own) and the adjoint (negated taps) run star instances,
    bitwise, f64."""
    from repro_torch.core import padding
    from repro_torch.kernels import _host
    spec = tst.SPECS[name]
    state, coeffs = tst.make_problem(spec, (24, 40, 36), dtype="f64", seed=14,
                                     device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    adj = tir.adjoint(spec)
    adj_arrays, adj_scalars = adj.map_coeffs(arrays, scalars)
    assert _host.star_layout(adj.op) > 4
    for fused in (True, False):
        assert_bitwise(*_star_vs_plain(adj.op, state, adj_arrays, adj_scalars,
                                       4, d_w=8, n_f=2, fused=fused))
    mop, mstate, packed = padding.pad_batch(spec, [state], [coeffs],
                                            (32, 48, 40))
    marrays, mscalars = tir.split_coeffs(mop, packed)
    assert _host.star_layout(mop) > 0
    assert_bitwise(*_star_vs_plain(mop, (mstate[0][0], mstate[1][0]),
                                   marrays[0], mscalars, 6, d_w=8, n_f=2,
                                   fused=True))


@pytest.mark.gpu
def test_star_kernel_zero_steps_is_the_identity(cuda):
    spec = tst.SPECS["25pt-const"]
    state, coeffs = tst.make_problem(spec, (16, 20, 24), dtype="f64", seed=15,
                                     device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    star0, k1 = tkern.STAR_LAUNCHES.count, tkern.LAUNCHES.count
    cur, prev = tkern.mwd_run(spec, state, arrays, scalars, 0)
    assert (tkern.STAR_LAUNCHES.count, tkern.LAUNCHES.count) == (star0, k1)
    assert torch.equal(cur, state[0])


def _user_ops():
    """Ops that keep the generic instance: a diagonal tap added to
    7pt-var, 25pt-const's taps reordered, and a radius-2 star."""
    v = tst.SPECS["7pt-var"]
    diag = tir.StencilOp("7pt-var-diag", v.taps + (
        tir.Tap(1, 1, 0, tir.array(7)),))
    c = tst.SPECS["25pt-const"]
    order = (c.taps[0],) + tuple(reversed(c.taps[1:]))
    reordered = tir.StencilOp("25pt-const-rev", order, time_order=2,
                              scale=c.scale, default_scalars=c.default_scalars)
    r2 = tir.StencilOp("13pt-var", (tir.Tap(0, 0, 0, tir.array(0)),) + tuple(
        tir.Tap(*(d * s if a == ax else 0 for a in range(3)), tir.array(ax + 1))
        for ax in range(3) for d in (1, 2) for s in (-1, 1)))
    return [diag, reordered, r2]


@pytest.mark.gpu
@pytest.mark.parametrize("which", [0, 1, 2])
def test_user_ops_keep_the_generic_instance(cuda, which):
    """No star layout matches: the launches leave the star counter alone
    and equal the plain version bitwise."""
    from repro_torch.kernels import _host
    spec = _user_ops()[which]
    assert _host.star_layout(spec) == 0
    state, coeffs = tst.make_problem(spec, (20, 24, 40), dtype="f64", seed=16,
                                     device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    star0, k1 = tkern.STAR_LAUNCHES.count, tkern.LAUNCHES.count
    got, want = _kernel_vs_plain(spec, state, arrays, scalars, 4, d_w=8,
                                 n_f=2, fused=True)
    assert tkern.LAUNCHES.count > k1
    assert tkern.STAR_LAUNCHES.count == star0
    assert_bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d_w,n_f", SOLVE_PLANS)
@pytest.mark.parametrize("name", ["7pt-var", "25pt-const"])
def test_star_instance_keeps_the_launch_plan(cuda, name, d_w, n_f,
                                             monkeypatch):
    """At 512 columns in f64 the star instance's configuration equals the
    generic instance's (same cluster, slab, staging, threads and shared
    memory), and the star instance uses no more static shared memory."""
    spec = tst.SPECS[name]
    if d_w % (2 * spec.radius):
        d_w, n_f = 8, 1
    state, coeffs = tst.make_problem(spec, (2 * spec.radius + 6, 20, 512),
                                     dtype="f64", seed=17, device=cuda)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    job = tkern.prepare(spec, state, arrays, scalars, 4, d_w=d_w, n_f=n_f,
                        fused=True)
    star = tkern.kernel_config(job)
    monkeypatch.setattr(tkern, "star_code", lambda job: 0)
    assert tkern.kernel_config(job) == star
