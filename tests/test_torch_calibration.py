"""The port's calibration layer against the reference's, and K1's phase model.

`fit_ecm`, `model_residuals`, `energy` and the calibration artifact are
held to the reference's (`repro.core.models`) on the same numpy points: the
fitted constants and residuals to a relative 1e-9 (two least-squares solves
of the same small system, whose rounding may differ in the last digits),
the energy split to 1e-12 (the same three products), the artifact
byte-equal. `phase_schedule`, the count K1's time model prices, is held to
an explicit transcription of K1's loop (``csrc/mwd.cu``), and `fit_k1`
to costs it must recover exactly from points built under them (1e-9).
"""

import dataclasses
import math
import os

import numpy as np
import pytest

from repro.core import models as rmodels
from repro.core import specs as rspecs
from repro_torch.core import models as tmodels
from repro_torch.core import mwd as tmwd
from repro_torch.core import specs as tspecs
from repro_torch.core import stencils as tst
from test_torch_models import NAMES, pair

REL = 1e-9


def close(a, b, rel=REL):
    if math.isinf(b):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=rel, abs=1e-300), (a, b)


def calib_equal(t, r):
    for f in ("flops_per_s", "hbm_bytes_per_s", "t_dispatch_s",
              "max_rel_err"):
        close(getattr(t, f), getattr(r, f))
    assert t.n_points == r.n_points and t.spec == r.spec


RNG = np.random.default_rng(17)
POINT_SETS = {
    # all three terms observable
    "full": [(f, b, f / 5e9 + b / 1.2e9 + 2e-4) for f, b in
             [(1e6, 2e6), (4e6, 1e6), (2e6, 8e6), (9e6, 3e6)]],
    # noisy measurements of the same machine
    "noisy": [(f, b, (f / 7e12 + b / 3e12 + 5e-6)
               * (1 + 0.05 * RNG.standard_normal()))
              for f, b in RNG.uniform(1e8, 1e11, size=(12, 2))],
    # bytes explain everything: the flops rate clamps to inf
    "clamp_flops": [(0.0, 1e6, 1e-3), (0.0, 2e6, 2e-3), (0.0, 3e6, 3e-3)],
    # time falls with work: two clamps, a dispatch-only fit
    "clamp_two": [(1e6, 1e6, 3e-3), (2e6, 2e6, 2e-3), (3e6, 3e6, 1e-3)],
    # one point: a pure-dispatch fit
    "single": [(1e6, 2e6, 4e-3)],
}


@pytest.mark.parametrize("which", sorted(POINT_SETS))
def test_fit_ecm_equals_reference(which):
    pts = POINT_SETS[which]
    calib_equal(tmodels.fit_ecm(pts, spec="card"),
                rmodels.fit_ecm(pts, spec="card"))


def test_fit_ecm_clamp_cases_and_empty_set():
    c = tmodels.fit_ecm(POINT_SETS["clamp_flops"], spec="card")
    assert c.flops_per_s == math.inf
    assert c.hbm_bytes_per_s == pytest.approx(1e9, rel=1e-6)
    two = tmodels.fit_ecm(POINT_SETS["clamp_two"], spec="card")
    assert (two.flops_per_s, two.hbm_bytes_per_s) == (math.inf, math.inf)
    assert two.t_dispatch_s == pytest.approx(2e-3)
    one = tmodels.fit_ecm(POINT_SETS["single"], spec="card")
    assert one.n_points == 1 and one.max_rel_err < 1e-12
    with pytest.raises(ValueError):
        tmodels.fit_ecm([])
    with pytest.raises(ValueError):
        rmodels.fit_ecm([])
    # the default spec name is the process default's
    assert tmodels.fit_ecm(POINT_SETS["full"]).spec == \
        tspecs.current_spec().name


@pytest.mark.parametrize("which", ["full", "noisy", "clamp_flops"])
@pytest.mark.parametrize("given", [False, True])
def test_model_residuals_equal_reference(which, given):
    pts = [{"key": f"k{i}", "flops": f, "hbm_bytes": b, "measured_s": t,
            "model_s": t / 3} for i, (f, b, t) in enumerate(
                POINT_SETS[which])]
    tc = rc = None
    if given:
        tc = tmodels.fit_ecm(POINT_SETS["full"], spec="card")
        rc = rmodels.fit_ecm(POINT_SETS["full"], spec="card")
    got = tmodels.model_residuals(pts, tc)
    want = rmodels.model_residuals(pts, rc)
    assert set(got) == set(want) and got["n"] == want["n"]
    for f in ("mean_abs_rel_err", "max_abs_rel_err", "bias"):
        close(got[f], want[f])
    assert got["calibration"].keys() == want["calibration"].keys()
    for a, b in zip(got["per_point"], want["per_point"]):
        assert a.keys() == b.keys() and a["key"] == b["key"]
        for f in ("measured_s", "calibrated_s", "rel_err", "model_s"):
            close(a[f], b[f])
    empty = tmodels.model_residuals([], tc) if given else None
    if given:
        assert empty["n"] == 0 and empty["max_abs_rel_err"] == 0.0


def test_energy_equals_reference():
    ref = rspecs.get_spec("tpu-v5e")
    port = dataclasses.replace(
        tspecs.get_spec("h100-sxm"), static_power_w=ref.static_power_w,
        joules_per_flop=ref.joules_per_flop,
        joules_per_hbm_byte=ref.joules_per_hbm_byte)
    for flops, nbytes, t in ((1e12, 3e10, 0.02), (0.0, 0.0, 1.0),
                             (7e9, 1e6, 1e-4)):
        got = tmodels.energy(flops, nbytes, t, port)
        want = rmodels.energy(flops, nbytes, t, ref)
        for f in ("core_j", "hbm_j", "static_j", "total_j"):
            close(getattr(got, f), getattr(want, f), 1e-12)
    # the committed spec's measured constants price a run
    e = tmodels.energy(1e12, 3e10, 0.02)
    spec = tspecs.current_spec()
    assert e.static_j == pytest.approx(spec.static_power_w * 0.02)
    assert e.total_j > e.static_j > 0


def test_calibration_artifact_equals_reference(tmp_path):
    pts = POINT_SETS["noisy"]
    tdir, rdir = tmp_path / "port", tmp_path / "ref"
    tpath = tmodels.save_calibration(tmodels.fit_ecm(pts, spec="card"),
                                     str(tdir))
    rpath = rmodels.save_calibration(rmodels.fit_ecm(pts, spec="card"),
                                     str(rdir))
    assert os.path.basename(tpath) == os.path.basename(rpath) == \
        "ecm-card.json"
    assert tpath == tmodels.calibration_path(str(tdir), "card")
    back = tmodels.load_calibration(str(tdir), "card")
    calib_equal(back, rmodels.load_calibration(str(rdir), "card"))
    assert back == tmodels.fit_ecm(pts, spec="card")
    assert tmodels.load_calibration(str(tdir), "other") is None
    with pytest.raises(ValueError, match="spec"):
        tmodels.save_calibration(dataclasses.replace(back, spec=""),
                                 str(tdir))


# ---------------------------------------------------------------------------
# K1's phase model
# ---------------------------------------------------------------------------

def loop_phases(geo, warps):
    """K1's loop (csrc/mwd.cu), one CTA of one tile at a time: which
    barrier ends each phase, and the rows on the busiest warp."""
    comp, (_, py, _) = geo.comp, geo.pads
    lo_z, hi_z, lo_y, hi_y, lo_x, hi_x = geo.bounds
    push, _ = tmwd.barrier_schedule(geo)
    exchange = bool(push.any())
    shape = (comp.n_rows, comp.n_tiles)
    cluster, cta, work = (np.zeros(shape, int) for _ in range(3))
    for i in range(comp.n_rows):
        for k in range(comp.n_tiles):
            if geo.fused and not comp.active[i, k]:
                continue
            c = b = w = 0
            c, b = (c + 1, b) if exchange else (c, b + 1)     # first loads
            for j in range(geo.n_j):
                for tau in range(comp.t_steps):
                    zs = j * geo.n_f - (tau + 1) * geo.radius
                    z0, z1 = max(zs, lo_z), min(zs + geo.n_f, hi_z)
                    ya = max(int(comp.y0[i, k, tau]) + py, lo_y)
                    yb = min(int(comp.y1[i, k, tau]) + py, hi_y)
                    live = z1 > z0 and yb > ya and hi_x > lo_x
                    if live:
                        w += -(-((z1 - z0) * (yb - ya)) // warps)
                    if tau == comp.t_steps - 1:
                        if push[i, k].any():
                            c += 1
                        else:
                            b += 1
                    elif live and push[i, k, tau]:
                        c += 1
                    elif live:
                        b += 1
                if j >= comp.d_w // geo.n_f:
                    b += 1                                    # emission
            cluster[i, k], cta[i, k], work[i, k] = c, b, w
    return cluster, cta, work


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fused", [True, False])
def test_phase_schedule_equals_the_kernels_loop(name, fused):
    _, spec = pair(name)
    for d_w_k, n_f, shape, steps, warps in ((1, 2, (16, 24, 20), 6, 8),
                                            (2, 1, (9, 37, 13), 5, 16),
                                            (1, 4, (20, 30, 10), 9, 8)):
        d_w = 2 * spec.radius * d_w_k
        n_f = n_f if d_w % n_f == 0 else 1
        geo = tmwd.k1_geometry(spec.radius, shape, d_w, n_f, steps,
                               fused=fused)
        got = tmwd.phase_schedule(geo, warps)
        want = loop_phases(geo, warps)
        for g, w in zip(got, want):
            assert g.tolist() == w.tolist()
        # the cluster phases are halo_schedule's barriers plus the first
        _, barriers = tmwd.barrier_schedule(geo)
        exchange = int(tmwd.barrier_schedule(geo)[0].any())
        live = comp_live(geo)
        assert (got[0] == (barriers + exchange) * live).all()


def comp_live(geo):
    return (geo.comp.active.astype(int) if geo.fused
            else np.ones_like(geo.comp.active, int))


def test_k1_model_prices_phases_at_the_spec_costs():
    chip = tspecs.current_spec()
    grid = (64, 64, 64)
    op7, op25 = tst.SPECS["7pt-var"], tst.SPECS["25pt-const"]
    p = tmodels.k1_predict(op7, grid, 8, 2, 8)
    assert p.t_phase == pytest.approx(sum(
        p.phases[k] * getattr(chip, f)
        for k, f in tmodels.K1_COSTS.items()))
    assert p.t_total == pytest.approx(p.t_fixed + p.t_phase)
    assert p.phases["cluster"] > 0 and p.phases["cta"] > 0
    # the 25-point ops at dw8 push no halo: only block-barrier phases, and
    # n_f is visible to the model (fewer, fatter phases at n_f = 4)
    q2 = tmodels.k1_predict(op25, grid, 8, 2, 8)
    q4 = tmodels.k1_predict(op25, grid, 8, 4, 8)
    assert q2.phases["cluster"] == q4.phases["cluster"] == 0
    assert q4.phases["cta"] < q2.phases["cta"]
    assert q4.t_phase != q2.t_phase
    assert q2.phases["row_loads"] % (len(op25.taps)
                                     + op25.n_coeff_arrays) == 0


@pytest.mark.parametrize("costs", [(2e-6, 2e-7, 1e-7), (3e-6, 0.0, 5e-8)])
def test_fit_k1_recovers_the_costs_it_was_built_with(costs):
    chip = dataclasses.replace(
        tspecs.current_spec(), **dict(zip(tmodels.K1_COSTS.values(),
                                          costs)))
    pts = []
    for name in ("7pt-const", "7pt-var", "25pt-const", "25pt-var"):
        spec = tst.SPECS[name]
        for grid in ((32, 48, 64), (40, 40, 200)):
            for d_w, n_f in ((8, 1), (8, 2), (8, 4), (16, 2)):
                if d_w % n_f or not tmodels.smem_fits(spec, d_w, n_f,
                                                      grid[2], chip=chip):
                    continue
                pred = tmodels.k1_predict(spec, grid, d_w, n_f, 8, chip=chip)
                pts.append(tmodels.k1_fit_point(f"{name}{grid}{d_w}{n_f}",
                                                pred, pred.t_total))
    calib = tmodels.fit_k1(pts)
    for f, c in zip(tmodels.K1_COSTS.values(), costs):
        assert calib.costs_s[f] == pytest.approx(c, rel=REL, abs=1e-15)
    assert calib.max_rel_err < 1e-9 and calib.n_points == len(pts)
    rep = tmodels.k1_residuals(pts)
    assert rep["max_abs_rel_err"] < 1e-9
    assert rep["per_point"][0]["model_s"] == pts[0]["model_s"]
    with pytest.raises(ValueError):
        tmodels.fit_k1([])


def test_k1_fit_point_reads_a_sweep_record():
    from repro_torch.core.mwd import MWDPlan
    from repro_torch.launch import sweep
    spec = tst.SPECS["7pt-var"]
    terms = sweep.k1_terms(spec, (32, 40, 48), 8, MWDPlan(d_w=8, n_f=2), 1,
                           4)
    pred = tmodels.k1_predict(spec, (32, 40, 48), 8, 2, 8)
    a = tmodels.k1_fit_point("k", terms, 1e-3)
    b = tmodels.k1_fit_point("k", pred, 1e-3)
    assert a["phases"] == b["phases"]
    assert a["fixed_s"] == pytest.approx(b["fixed_s"], rel=1e-12)
    assert a["model_s"] == pytest.approx(b["model_s"], rel=1e-12)
