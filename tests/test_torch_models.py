"""The port's machine model against the reference's, and K1's fit twin.

The analytic models the port keeps from `repro.core.models` are held to a
relative 1e-12 of the reference's on the same inputs (the ECM and roofline
on a port `DeviceSpec` built from the reference spec's numbers). The
shared-memory fit `models.mwd_smem_plan` is held against hand counts from
``csrc/mwd.cu`` and against the ring depths of the K1 mirror test; the
tensor-free barrier schedule against `stencil_mwd.halo_schedule` on
prepared CPU jobs. On the card, `chip_smoke.py` and `test_torch_gpu.py`
hold the twin against the kernel's own `kernel_config`.
"""

import dataclasses
import math

import pytest

from repro.core import ir as rir
from repro.core import models as rmodels
from repro.core import mwd as rmwd
from repro.core import specs as rspecs
from repro.core import stencils as rst
from repro_torch.core import ir as tir
from repro_torch.core import models as tmodels
from repro_torch.core import mwd as tmwd
from repro_torch.core import specs as tspecs
from repro_torch.core import stencils as tst
from repro_torch.core import traffic as ttraffic
from repro_torch.kernels import stencil_mwd as tkern
from test_torch_mwd import aniso11
from test_torch_mwd_ring import ring_depths

NAMES = list(rst.SPECS) + ["aniso11"]
REL = 1e-12


def pair(name):
    if name == "aniso11":
        return aniso11(rir), aniso11(tir)
    return rst.SPECS[name], tst.SPECS[name]


def close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def port_spec_like(ref):
    """A port DeviceSpec holding the reference spec's numbers."""
    base = tspecs.get_spec("h100-sxm")
    return dataclasses.replace(
        base, name=f"{ref.name}-numbers",
        peak_flops_bf16=ref.peak_flops_bf16,
        peak_flops_f32=ref.peak_flops_vpu_f32, hbm_bw=ref.hbm_bw,
        smem_bw=ref.vmem_bw, launch_s=ref.hbm_latency_s)


def widths(spec):
    step = 2 * spec.radius
    return [step, 2 * step, 4 * step]


@pytest.mark.parametrize("word", [4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_eq3_eq5_and_baselines_match_reference(name, word):
    rspec, tspec = pair(name)
    assert tspec.bytes_per_cell == rspec.bytes_per_cell
    close(tmodels.spatial_code_balance(tspec, word),
          rmodels.spatial_code_balance(rspec, word))
    for d_w in widths(rspec):
        close(tmodels.code_balance(tspec, d_w, word),
              rmodels.code_balance(rspec, d_w, word))
        for n_f in (1, 2, d_w):
            n_xb = 512 * word * rspec.bytes_per_cell
            close(tmodels.cache_block_bytes(tspec, d_w, n_f, n_xb),
                  rmodels.cache_block_bytes(rspec, d_w, n_f, n_xb))
            for nz, nx in ((16, 24), (512, 512)):
                close(tmodels.mwd_tile_bytes(tspec, d_w, n_f, nz, nx, word),
                      rmodels.mwd_tile_bytes(rspec, d_w, n_f, nz, nx, word))
        plan_t, plan_r = tmwd.MWDPlan(d_w=d_w), rmwd.MWDPlan(d_w=d_w)
        got = tmwd.traffic_per_pass(tspec, plan_t, (20, 30, 40), word)
        want = rmwd.traffic_per_pass(rspec, plan_r, (20, 30, 40), word)
        assert got.keys() == want.keys()
        for k in got:
            close(got[k], want[k])
    for t_b, by, bz in ((1, 16, 16), (4, 16, 16), (3, 8, 32)):
        close(tmodels.ghostzone_code_balance(tspec, t_b, by, bz, word),
              rmodels.ghostzone_code_balance(rspec, t_b, by, bz, word))
        close(tmodels.ghostzone_redundancy(tspec.radius, t_b, by, bz),
              rmodels.ghostzone_redundancy(rspec.radius, t_b, by, bz))


@pytest.mark.parametrize("batch", [1, 2, 7])
def test_batch_amortization_matches_reference(batch):
    for t_item, t_d in ((1e-3, 5e-6), (2e-6, 4e-6), (0.0, 1e-5)):
        close(tmodels.batch_amortized_time(t_item, batch, t_d),
              rmodels.batch_amortized_time(t_item, batch, t_d))
        if t_item or t_d:
            close(tmodels.batch_amortization(t_item, batch, t_d),
                  rmodels.batch_amortization(t_item, batch, t_d))
    # the port's default dispatch is the spec's measured launch
    spec = tspecs.current_spec()
    assert tmodels.batch_amortized_time(1e-3, batch) == pytest.approx(
        batch * 1e-3 + spec.launch_s)
    with pytest.raises(ValueError):
        tmodels.batch_amortized_time(1e-3, 0, 1e-6)


@pytest.mark.parametrize("ref_name", ["tpu-v5e", "cpu-host"])
@pytest.mark.parametrize("name", NAMES)
def test_ecm_and_roofline_match_reference_on_the_same_numbers(name,
                                                              ref_name):
    rspec, tspec = pair(name)
    rchip = rspecs.get_spec(ref_name)
    tchip = port_spec_like(rchip)
    for word in (4, 8):
        for lups, red in ((8 * 8 * 8, 1.0), (512.0 ** 3, 1.0),
                          (64.0 ** 3, 1.7)):
            bc = rmodels.code_balance(rspec, 2 * rspec.radius, word)
            r = rmodels.ecm_predict(rspec, bc, lups, rchip, word, red)
            t = tmodels.ecm_predict(tspec, bc, lups, tchip, word, red)
            close(t.t_compute, r.t_compute)
            close(t.t_smem, r.t_vmem)
            close(t.t_hbm, r.t_hbm)
            close(t.t_latency, r.t_latency)
            close(t.t_total, r.t_total)
            close(t.glups, r.glups)
            assert t.dominant == {"vmem": "smem"}.get(r.dominant, r.dominant)
    for flops, nbytes in ((1e6, 1e4), (1e12, 1e12), (5e9, 3e7)):
        r = rmodels.roofline(flops, nbytes, 0.0, rchip)
        t = tmodels.roofline(flops, nbytes, 0.0, tchip)
        for f in ("t_compute", "t_memory", "t_collective", "t_latency",
                  "t_bound", "roofline_fraction"):
            close(getattr(t, f), getattr(r, f))
        assert t.dominant == r.dominant
    # the collective term: the bytes a card sends over all of its NVLink
    # links one way (half the data sheet's both-ways rate)
    one_way = tchip.ici_bw_per_link * tchip.ici_links / 2
    assert one_way == 450e9
    assert tmodels.roofline(1e6, 1e6, 1e9, tchip).t_collective == \
        1e9 / one_way


def test_smem_plan_hand_counts_from_mwd_cu():
    """choose()/smem_bytes() of csrc/mwd.cu, counted by hand.

    7pt-const, d_w 8, n_f 2, nx 512, f32: R 1, T 8, ahead 1, depth 2*2+8+1
    = 13, cdepth 4+7 = 11, wy 10; tap table round16(13*7*4) = 368; x
    interior 510, c_min 8, slab (64+3)//4*4 = 64, cluster 8, wx 68; rings
    round16(2*13*10*68*4) = 70720; per SM 233472 // (71088 + 2600 + 2048)
    = 3, so 256 threads. 7pt-var at nx 200: interior 198, c_min 4, slab
    (50+3)//4*4 = 52, cluster 4, wx 56, rings 58240 + 368; staging the 7
    streams (7*11*8*52*4 = 128128 more) drops to one CTA per SM, so they
    stay in place. 25pt-var at nx 512: R 4, T 2, ahead 2, depth 18, cdepth
    10, wy 16, taps round16(18*25*4) = 1808, slab 64, wx 72, rings 165888:
    one CTA per SM, 512 threads; staged would exceed 232448.
    """
    S = tmodels.SmemPlan
    assert tmodels.mwd_smem_plan(tst.SPECS["7pt-const"], 8, 2, 512, 4) == S(
        cluster=8, slab=64, stage=0, threads=256, smem_bytes=71088,
        per_sm=3, depth=13, cdepth=11)
    assert tmodels.mwd_smem_plan(tst.SPECS["7pt-var"], 8, 2, 200, 4) == S(
        cluster=4, slab=52, stage=0, threads=256, smem_bytes=58608,
        per_sm=3, depth=13, cdepth=11)
    assert tmodels.mwd_smem_plan(tst.SPECS["25pt-var"], 8, 2, 512, 4) == S(
        cluster=8, slab=64, stage=0, threads=512, smem_bytes=167696,
        per_sm=1, depth=18, cdepth=10)


def test_smem_plan_counts_the_static_shared_memory():
    """F3: choose() holds the rings beside the instance's static shared
    memory (3120 bytes) under the opt-in limit of 232,448. 7pt-const, f32,
    40 columns, d_w 32, n_f 1: R 1, T 32, ahead 1, depth 35, wy 34, taps
    round16(35*7*4) = 992; 38 interior columns. Two CTAs take slabs of 20
    (wx 24) and rings of 992 + 2*35*34*24*4 = 229,472 bytes, which fit
    232,448 alone but not beside 3120 (232,592): the kernel once refused
    this plan at launch. Three CTAs take slabs of 16 (wx 20), 191,392."""
    op = tst.SPECS["7pt-const"]
    assert tmodels.MWD_STATIC_SMEM == 3120
    plan = tmodels.mwd_smem_plan(op, 32, 1, 40, 4)
    assert (plan.cluster, plan.slab, plan.smem_bytes) == (3, 16, 191392)
    chip = tspecs.current_spec()
    rings_alone = dataclasses.replace(
        chip, smem_block_bytes=chip.smem_block_bytes + 3120)
    old = tmodels.mwd_smem_plan(op, 32, 1, 40, 4, chip=rings_alone)
    assert (old.cluster, old.slab, old.smem_bytes) == (2, 20, 229472)
    # every plan the twin takes fits beside the static bytes
    for nx in (40, 200, 512):
        for d_w in range(2, 48, 2):
            p = tmodels.mwd_smem_plan(op, d_w, 1, nx, 4)
            assert p is None or (p.smem_bytes + tmodels.MWD_STATIC_SMEM
                                 <= chip.smem_block_bytes)


def test_smem_plan_refusals_and_fit_boundary():
    op = tst.SPECS["7pt-const"]
    chip = tspecs.current_spec()
    # not K1 plans
    assert tmodels.mwd_smem_plan(op, 7, 1, 64) is None
    assert tmodels.mwd_smem_plan(op, 8, 3, 64) is None
    assert tmodels.mwd_smem_plan(tst.SPECS["25pt-var"], 12, 1, 64) is None
    # the widths at n_f = 1 whose rings fit a block, at 512 columns in f32:
    # contiguous from 2R, every wider width fails too (E_SMEM); wider
    # widths take more CTAs per tile
    plans = {d: tmodels.mwd_smem_plan(op, d, 1, 512)
             for d in range(2, 64, 2)}
    fits = [d for d, p in plans.items() if p is not None]
    assert fits == list(range(2, fits[-1] + 1, 2)) and fits[-1] == 24
    assert all(p.smem_bytes <= chip.smem_block_bytes
               for p in plans.values() if p is not None)
    assert plans[24].cluster > plans[8].cluster == 8
    # smem_fits also wants one CTA per SM by the kernel's own count: at
    # d_w 18 the rings take 229072 bytes, and 229072 + 4648 > 233472
    assert plans[18].smem_bytes == 229072 and plans[18].per_sm == 0
    assert not tmodels.smem_fits(op, 18, 1, 512)
    assert tmodels.smem_fits(op, 16, 1, 512)
    # less shared memory: fewer widths fit
    small = dataclasses.replace(chip, smem_block_bytes=48 * 1024)
    assert max(d for d in fits if tmodels.mwd_smem_plan(
        op, d, 1, 512, chip=small) is not None) < fits[-1]
    # no cluster large enough: the slab rings alone overflow a block
    tiny = dataclasses.replace(chip, max_cluster=1)
    assert tmodels.mwd_smem_plan(op, 8, 2, 4096, chip=tiny) is None


def test_smem_plan_at_a_requested_cluster_hand_counts():
    """choose() of csrc/mwd.cu at a requested cluster size tries that size
    alone (the paper's thread-group size), counted by hand.

    7pt-const, d_w 4, n_f 4, nx 512, f32: R 1, T 4, ahead 1, depth
    2*4+4+1 = 13, cdepth 8+3 = 11, wy 6, taps round16(13*7*4) = 368;
    interior 510. Cluster 2: slabs of 256 (wx 260), rings
    2*13*6*260*4 = 162240, 162608 bytes, one CTA per SM (233472 //
    (162608 + 4648)), 512 threads. Cluster 4: slabs of 128 (wx 132), rings
    82368, 82736 bytes, two per SM, 256 threads. Cluster 1: slab 512 (wx
    516), rings 321984 beyond the block (E_SMEM). Cluster 14: ceil(510/14)
    = 37 rounds to 40, which 13 CTAs cover (E_CLUSTER_SIZE). The kernel
    alone would take 8 CTAs (c_min = ceil(510/64)).
    """
    S = tmodels.SmemPlan
    op = tst.SPECS["7pt-const"]
    assert tmodels.mwd_smem_plan(op, 4, 4, 512, 4, cluster=2) == S(
        cluster=2, slab=256, stage=0, threads=512, smem_bytes=162608,
        per_sm=1, depth=13, cdepth=11)
    assert tmodels.mwd_smem_plan(op, 4, 4, 512, 4, cluster=4) == S(
        cluster=4, slab=128, stage=0, threads=256, smem_bytes=82736,
        per_sm=2, depth=13, cdepth=11)
    assert tmodels.mwd_cluster_slab(510, 14, 4) == (40, 13)
    for c in (1, 14):
        assert tmodels.mwd_smem_plan(op, 4, 4, 512, 4, cluster=c) is None
        assert not tmodels.smem_fits(op, 4, 4, 512, 4, cluster=c)
        with pytest.raises(ValueError, match=f"cluster={c}"):
            tmodels.k1_predict(op, (64, 64, 512), 4, 4, 8, cluster=c)
    assert tmodels.mwd_smem_plan(op, 4, 4, 512, 4).cluster == 8
    # 25pt-var at nx 20 has 12 interior columns: in f32, 6 CTAs round to
    # slabs of 4, which 3 CTAs cover; in f64 6 CTAs take slabs of 2,
    # narrower than R = 4
    assert tmodels.mwd_cluster_slab(12, 6, 4) == (4, 3)
    assert tmodels.mwd_cluster_slab(12, 6, 8) == (2, 6)
    for word in (4, 8):
        assert tmodels.mwd_smem_plan(tst.SPECS["25pt-var"], 8, 2, 20, word,
                                     cluster=6) is None


@pytest.mark.parametrize("name", NAMES)
def test_requested_cluster_prices_its_own_plan(name):
    """The size the kernel picks, requested, gives the kernel's plan back;
    every other size that fits is priced at its own slab and residency."""
    _, op = pair(name)
    d_w = 12 if op.radius == 3 else 8
    for nx in (40, 200, 512):
        natural = tmodels.mwd_smem_plan(op, d_w, 2, nx)
        assert tmodels.mwd_smem_plan(op, d_w, 2, nx,
                                     cluster=natural.cluster) == natural
        nxr = nx - 2 * op.radius
        for c in range(1, tspecs.current_spec().max_cluster + 1):
            plan = tmodels.mwd_smem_plan(op, d_w, 2, nx, cluster=c)
            slab, cl = tmodels.mwd_cluster_slab(nxr, c, 4)
            if cl != c:
                assert plan is None
            if plan is None:
                continue
            assert (plan.cluster, plan.slab) == (c, slab)
            pred = tmodels.k1_predict(op, (32, 48, nx), d_w, 2, 4, cluster=c)
            assert pred.smem == plan


@pytest.mark.parametrize("name", NAMES)
def test_row_overhead_bytes_match_reference(name):
    rspec, tspec = pair(name)
    for d_w in widths(rspec):
        for n_f in (1, 2, d_w):
            for grid in ((16, 20, 24), (512, 512, 512)):
                for word in (4, 8):
                    close(tmodels.mwd_row_overhead_bytes(tspec, d_w, n_f,
                                                         grid, word),
                          rmodels.mwd_row_overhead_bytes(rspec, d_w, n_f,
                                                         grid, word))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_f,dt", [(1, "f32"), (2, "f32"), (4, "f64"),
                                    (2, "bf16")])
def test_smem_plan_ring_depths_match_the_mirror(name, n_f, dt):
    """depth/cdepth/ahead as `ring_depths` (test_torch_mwd_ring) derives them
    from a prepared job, at the d_w the mirror uses."""
    _, spec = pair(name)
    d_w = 12 if spec.radius == 3 else 8
    for shape in ((16, 24, 20), (12, 28, 200)):
        state, coeffs = tst.make_problem(spec, shape, dtype=dt, seed=0,
                                         device="cpu")
        arrays, scalars = tir.split_coeffs(spec, coeffs)
        job = tkern.prepare(spec, state, arrays, scalars, 4, d_w=d_w,
                            n_f=n_f, fused=True)
        _, depth, cdepth = ring_depths(job)
        plan = tmodels.mwd_smem_plan(spec, d_w, n_f, shape[2],
                                     state[0].element_size())
        assert (plan.depth, plan.cdepth) == (depth, cdepth)
        nxr = job.bounds[5] - job.bounds[4]
        assert plan.cluster == -(-nxr // plan.slab)
        e = 16 // state[0].element_size()
        assert plan.slab % e == 0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fused", [True, False])
def test_tensor_free_barrier_schedule_equals_halo_schedule(name, fused):
    _, spec = pair(name)
    for d_w_k, n_f, shape, steps in ((1, 2, (16, 24, 20), 6),
                                     (2, 1, (9, 37, 13), 5),
                                     (1, 4, (20, 30, 10), 9)):
        d_w = 2 * spec.radius * d_w_k
        n_f = n_f if d_w % n_f == 0 else 1
        state, coeffs = tst.make_problem(spec, shape, seed=1, device="cpu")
        arrays, scalars = tir.split_coeffs(spec, coeffs)
        job = tkern.prepare(spec, state, arrays, scalars, steps, d_w=d_w,
                            n_f=n_f, fused=fused)
        geo = tmwd.k1_geometry(spec.radius, shape, d_w, n_f, steps,
                               fused=fused)
        assert (geo.pads, geo.bounds, geo.n_j) == (job.pads, job.bounds,
                                                   job.n_j)
        got = tmwd.barrier_schedule(geo)
        want = tkern.halo_schedule(job)
        assert (got[0] == want[0]).all() and (got[1] == want[1]).all()


def test_k1_model_terms():
    chip = tspecs.current_spec()
    grid = (64, 64, 64)
    op7, op25 = tst.SPECS["7pt-var"], tst.SPECS["25pt-const"]
    p = tmodels.k1_predict(op7, grid, 8, 2, 8)
    geo = tmwd.k1_geometry(1, grid, 8, 2, 8)
    assert p.launches == geo.comp.n_rows
    assert p.t_launch == pytest.approx(p.launches * chip.launch_s)
    assert p.hbm_bytes == pytest.approx(
        tmodels.mwd_schedule_bytes(op7, grid, 8, p.launches))
    assert p.t_bytes == pytest.approx(p.hbm_bytes / chip.hbm_bw)
    assert p.t_flops == pytest.approx(op7.flops_per_lup * 64 ** 3 * 8
                                      / chip.peak_flops_f32)
    assert p.phases["cluster"] > 0 and p.t_phase == pytest.approx(
        tmodels.k1_phase_cost(p.phases, chip))
    assert p.t_total == pytest.approx(max(p.t_bytes, p.t_flops)
                                      + p.t_phase + p.t_launch)
    # fatter phases: fewer barriers
    assert (tmodels.k1_predict(op7, grid, 8, 4, 8).phases["cluster"]
            < p.phases["cluster"])
    # the per-row mode copies both grids per row: more bytes, same rest
    row = tmodels.k1_predict(op7, grid, 8, 2, 8, fused=False)
    assert row.hbm_bytes > p.hbm_bytes and row.launches == p.launches
    # the 25-point ops at dw8 push no halo: no cluster-barrier phase
    assert tmodels.k1_predict(op25, grid, 8, 2, 8).phases["cluster"] == 0
    with pytest.raises(ValueError, match="no K1 launch"):
        tmodels.k1_predict(op7, (8, 8, 4096), 8, 2, 2,
                           chip=dataclasses.replace(chip, max_cluster=1))


def test_traffic_counts():
    op = tst.SPECS["7pt-var"]
    grid = (32, 40, 48)
    run = ttraffic.mwd_run_traffic(op, grid, 8, 8, 2)
    geo = tmwd.k1_geometry(1, grid, 8, 2, 8)
    assert run["launches"] == geo.comp.n_rows
    assert run["bytes"] == pytest.approx(
        tmodels.mwd_schedule_bytes(op, grid, 8, geo.comp.n_rows))
    assert ttraffic.mwd_run_traffic(op, grid, 8, 8, 2,
                                    fused=False)["bytes"] > run["bytes"]
    one = ttraffic.mwd_pass_traffic(op, grid, 8, 2)
    assert one["bytes"] * run["launches"] == pytest.approx(run["bytes"])
    assert one["steps_per_pass"] == 4
    # compulsory bytes are the floor of every count
    compulsory = (2 + op.n_coeff_arrays) * math.prod(grid) * 4
    for t in (ttraffic.spatial_pass_traffic(op, grid, 8),
              ttraffic.ghostzone_pass_traffic(op, grid, 4, 16, 16)):
        assert t["bytes"] >= compulsory
    from repro_torch.kernels import stencil_fused as fu
    from repro_torch.kernels import stencil_sweep as sw
    plan = sw.choose_tile(op, grid, 8, 4)
    assert tmodels.sweep_tile_bytes(op, grid, 8, 4) == sw.tile_bytes(
        op, grid, plan, 4)
    fplan = fu.choose_tile(op, 4, 16, grid[2], 4)
    assert tmodels.fused_window_bytes(op, grid, 4, 16, 16, 4) == \
        fu.window_bytes(op, grid, 4, 16, 16, fplan.bx, 4, ty=fplan.ty)
