"""The port's tuner against the reference's, and its timing policy.

The parts of the search the port shares with the reference (`_neighbors`,
the hill-climb, `max_evals`, the baseline first, the prune rule) are held
against `repro.core.autotune` on the same injected scorer, with each
package's fit and model monkeypatched to the same functions. The seed is
the port's own: the model's best plan over every plan that fits, where the
reference climbs under the model from the widest fit (F2). The port's own
model is held to what K1 launches (`_plan_valid`, `smem_fits`).
"""

import dataclasses
import math

import pytest

from repro.core import autotune as rtune
from repro.core import models as rmodels
from repro.core import mwd as rmwd
from repro_torch.core import autotune as ttune
from repro_torch.core import models as tmodels
from repro_torch.core import mwd as tmwd
from repro_torch.core import stencils as tst
from test_torch_models import NAMES, pair

FIELDS = ("d_w", "n_f", "t_block", "tg_x", "block_x", "fused")


def fields(plan):
    return tuple(getattr(plan, f) for f in FIELDS)


@pytest.mark.parametrize("radius", [1, 3, 4])
@pytest.mark.parametrize("cap", [None, 8, 24])
def test_neighbors_equal_reference(radius, cap):
    for d_w in (2 * radius, 4 * radius, 8 * radius):
        for n_f in (1, 2, 3, d_w):
            for fused in (True, False):
                kw = dict(d_w=d_w, n_f=n_f, fused=fused)
                got = ttune._neighbors(tmwd.MWDPlan(**kw), radius, cap)
                want = rtune._neighbors(rmwd.MWDPlan(**kw), radius, cap)
                assert [fields(p) for p in got] == [fields(p) for p in want]


def synthetic(plan) -> float:
    """One scorer for both packages: a bowl in (d_w, n_f), fused ahead."""
    return (100.0 - (plan.d_w - 12) ** 2 - 3 * (plan.n_f - 3) ** 2
            + (0.5 if plan.fused else 0.0) - plan.tg_x)


def fit(spec, d_w, n_f, *a, **k):
    return d_w <= 20 and n_f <= 8


def brute_force_seed(radius, tg, cap):
    """The best plan under `synthetic` over every plan `fit` admits: D_w in
    steps of 2R while it fits, each N_F dividing it, fused then per-row."""
    step, best = 2 * radius, None
    d_w = step
    while d_w <= (cap or 4096) and fit(None, d_w, 1):
        for n_f in range(1, d_w + 1):
            for fused in (True, False):
                plan = tmwd.MWDPlan(d_w=d_w, n_f=n_f, tg_x=tg, fused=fused)
                if d_w % n_f == 0 and fit(None, d_w, n_f) and (
                        best is None or synthetic(plan) > synthetic(best)):
                    best = plan
        d_w += step
    return best


def reference_climb(seeds, radius, max_evals, cap):
    """The reference's measured phase from given seeds: the baseline first,
    then from each seed its `_neighbors` hill-climb under one `max_evals`
    budget. Returns the plans scored, in order."""
    evaluated = {}

    def ev(plan):
        if fields(plan) in evaluated:
            return evaluated[fields(plan)]
        if len(evaluated) >= max_evals:
            return -math.inf
        evaluated[fields(plan)] = synthetic(plan)
        return evaluated[fields(plan)]

    ev(rmwd.MWDPlan())
    for seed in seeds:
        cur = rmwd.MWDPlan(**dict(zip(FIELDS, fields(seed))))
        cur_score = ev(cur)
        improved = True
        while improved:
            improved = False
            for cand in rtune._neighbors(cur, radius, cap):
                s = ev(cand)
                if s > cur_score:
                    cur, cur_score, improved = cand, s, True
    return list(evaluated)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("devices_x,max_evals,cap", [(1, 64, None),
                                                     (1, 5, None),
                                                     (2, 64, 16)])
def test_search_equals_reference_on_the_same_scorer(monkeypatch, name,
                                                    devices_x, max_evals,
                                                    cap):
    """MWDPlan() scored first; then, from the port's seed, the reference's
    neighbours, hill-climb and budget; the winner the best plan scored."""
    rspec, tspec = pair(name)
    monkeypatch.setattr(tmodels, "smem_fits", fit)
    monkeypatch.setattr(ttune, "model_score", lambda *a, **k: synthetic)
    calls = []

    def score(plan):
        calls.append(fields(plan))
        return synthetic(plan)

    grid = (16, 24, 20)
    got = ttune.autotune(tspec, grid, devices_x=devices_x, measure=score,
                         max_evals=max_evals, d_w_cap=cap, prune_ratio=0.0)
    tgs = [d for d in range(1, devices_x + 1) if devices_x % d == 0]
    seeds = [brute_force_seed(tspec.radius, tg, cap) for tg in tgs]
    want = reference_climb(seeds, rspec.radius, max_evals, cap)
    assert calls[0] == fields(tmwd.MWDPlan())
    assert calls == want and calls[1] == fields(seeds[0])
    assert [fields(p) for p, _ in got.evaluated] == want
    assert got.score == max(s for _, s in got.evaluated)
    assert len(got.evaluated) <= max_evals


@pytest.mark.parametrize("prune_ratio", [0.25, 0.9])
def test_prune_rule_equals_reference(monkeypatch, prune_ratio):
    """A candidate whose model score is under `prune_ratio` of the best
    model score seen scores -inf unmeasured, as in the reference; the first
    scored plan is never pruned."""
    _, tspec = pair("7pt-const")
    monkeypatch.setattr(tmodels, "smem_fits", fit)
    analytic = lambda plan: 50.0 + synthetic(plan)     # noqa: E731
    monkeypatch.setattr(ttune, "model_score", lambda *a, **k: analytic)
    measured = []

    def score(plan):
        measured.append(fields(plan))
        return synthetic(plan)

    got = ttune.autotune(tspec, (16, 24, 20), measure=score, max_evals=64,
                         prune_ratio=prune_ratio)
    ref = -math.inf
    for plan, s in got.evaluated:
        a = analytic(plan)
        ref = max(ref, a)
        pruned = a < prune_ratio * ref and a < ref
        assert (s == -math.inf) == pruned
        assert (fields(plan) in measured) == (not pruned)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("grid", [(10, 18, 14), (12, 26, 18), (16, 64, 200),
                                  (64, 128, 512)])
def test_model_search_returns_plans_k1_launches(name, grid):
    _, spec = pair(name)
    res = ttune.autotune(spec, grid, d_w_cap=grid[1])
    plan = res.plan
    assert ttune._plan_valid(spec, plan)
    assert tmodels.smem_fits(spec, plan.d_w, plan.n_f, grid[2])
    assert plan.d_w <= max(grid[1], 2 * spec.radius)
    assert math.isfinite(res.score) and res.score > 0
    # never below the baseline the search scored first
    assert res.score >= res.evaluated[0][1]


def test_model_score_refuses_what_k1_refuses():
    spec = tst.SPECS["7pt-const"]
    score = ttune.model_score(spec, (64, 64, 512))
    assert score(tmwd.MWDPlan(d_w=8, n_f=3)) == -math.inf   # n_f | d_w
    assert score(tmwd.MWDPlan(d_w=7)) == -math.inf          # 2R | d_w
    assert score(tmwd.MWDPlan(d_w=8, tg_x=2)) == -math.inf  # one card
    assert score(tmwd.MWDPlan(d_w=64)) == -math.inf         # no fit
    assert score(tmwd.MWDPlan(d_w=8, n_f=2)) > 0
    # the batched launch pays its launches once
    one = ttune.model_score(spec, (16, 32, 32))(tmwd.MWDPlan(d_w=8))
    four = ttune.model_score(spec, (16, 32, 32), batch=4)(
        tmwd.MWDPlan(d_w=8))
    assert four > one


def test_seed_is_the_widest_fit():
    """The climb's seed: the model's best plan over every plan that fits,
    whose widths run from 2R to the widest fit at n_f = 1 (the reference's
    seed); at a cap of 2R only the narrowest diamond is left."""
    chip = ttune.devspecs.current_spec()
    grid = (64, 64, 512)
    for name in NAMES:
        _, spec = pair(name)
        plans = ttune._fitting_plans(spec, 512, chip)
        widest = max(p.d_w for p in plans)
        assert tmodels.smem_fits(spec, widest, 1, 512)
        assert not tmodels.smem_fits(spec, widest + 2 * spec.radius, 1, 512)
        assert all(tmodels.smem_fits(spec, p.d_w, p.n_f, 512)
                   and ttune._plan_valid(spec, p) for p in plans)
        analytic = ttune.model_score(spec, grid, chip=chip)
        seed = ttune._model_seed(analytic, spec, 512, chip)
        assert analytic(seed) == max(analytic(p) for p in plans)
        narrow = ttune._model_seed(analytic, spec, 512, chip,
                                   d_w_cap=2 * spec.radius)
        assert narrow.d_w == 2 * spec.radius


class FakeClock:
    def __init__(self, steps):
        self.t, self.steps = 0.0, list(steps)

    def __call__(self):
        return self.t

    def advance(self):
        self.t += self.steps.pop(0)


def test_time_callable_policy_on_a_fake_clock():
    # each launch takes the next duration; sync adds its own
    log = []
    clock = FakeClock([9.0, 3.0, 1.0, 2.0, 7.0])

    def launch():
        log.append("launch")
        clock.advance()

    def sync():
        log.append("sync")
        clock.t += 0.5            # device work still running at return

    med = ttune.time_callable(launch, reps=3, warmup=2, sync=sync,
                              clock=clock)
    # warm-ups (9, 3) untimed; timed 1, 2, 7 each + 0.5 for the sync
    assert med == pytest.approx(2.5)
    assert log == ["launch", "sync"] * 5
    clock = FakeClock([9.0, 3.0, 1.0, 2.0])
    assert ttune.time_callable(clock.advance, reps=3, warmup=1,
                               stat="min", clock=clock) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="median"):
        ttune.time_callable(lambda: None, stat="mean")
    clock = FakeClock([1.0, 1.0, 5.0, 2.0, 4.0, 3.0])
    a = lambda: clock.advance()   # noqa: E731
    assert ttune.time_callable_paired(a, a, reps=2, warmup=1,
                                      clock=clock) == (4.0, 2.0)


def test_measure_score_times_whole_calls_on_the_cpu():
    spec = tst.SPECS["7pt-const"]
    scorer = ttune.measure_score(spec, (6, 10, 8), n_steps=2, reps=2,
                                 warmup=1, device="cpu")
    assert scorer(tmwd.MWDPlan(d_w=2, n_f=1)) > 0
    assert scorer.measurements == 1
    assert scorer(tmwd.MWDPlan(d_w=2, n_f=3)) == -math.inf
    assert scorer(tmwd.MWDPlan(d_w=3, n_f=1)) == -math.inf
    assert scorer.measurements == 1                   # refused, not run
    batched = ttune.measure_score(spec, (6, 10, 8), n_steps=2, reps=1,
                                  batch=2, device="cpu")
    assert batched(tmwd.MWDPlan(d_w=4, n_f=2)) > 0
    res = ttune.autotune(spec, (6, 10, 8), measure=scorer, max_evals=4,
                         d_w_cap=10)
    assert len(res.evaluated) <= 4 and res.score >= res.evaluated[0][1]
    assert dataclasses.replace(res.plan).tg_x == 1


# K1 alone, ms, at every fused plan K1 launches up to d_w 16: 7pt-var,
# 512^3 x 8 steps, f32, by CUDA events (`chip_smoke.py --calibrate` on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6)
K1_MS_7PT_VAR_512 = {
    (2, 1): 60.74, (2, 2): 39.39, (4, 1): 60.86, (4, 2): 36.41,
    (4, 4): 27.65, (6, 1): 44.81, (6, 2): 29.87, (6, 3): 27.81,
    (6, 6): 30.18, (8, 1): 47.68, (8, 2): 32.99, (8, 4): 34.67,
    (8, 8): 32.61, (10, 1): 51.81, (10, 2): 37.41, (10, 5): 37.92,
    (10, 10): 32.14, (12, 1): 68.13, (12, 2): 44.24, (12, 3): 37.99,
    (12, 4): 32.7, (12, 6): 29.59, (12, 12): 56.04, (14, 1): 65.17,
    (14, 2): 44.03, (14, 7): 59.79, (14, 14): 54.56, (16, 1): 70.55,
    (16, 2): 49.24, (16, 4): 61.23}


def test_search_reaches_past_dw8_nf2_where_the_reference_search_did_not(
        monkeypatch):
    """F2: on the card's measured K1 times (plans not in the table score
    -inf), the reference's search structure (seed at the widest fit, climb
    under the model, then measure) ends at dw14.nf2, as the port's did
    before (PERF.md §6, run D), and never scores dw8.nf2, which is
    faster; the port's search seeds at the calibrated model's best plan
    and ends no slower than dw8.nf2, within the tune phase's budget of 12
    plans."""
    import unittest.mock as um
    from repro.core import stencils as rst
    spec, grid = tst.SPECS["7pt-var"], (512, 512, 512)
    lups = 512 ** 3 * 8

    def scorer(plan):
        ms = K1_MS_7PT_VAR_512.get((plan.d_w, plan.n_f)) if plan.fused \
            else None
        return lups / ms / 1e6 if ms else -math.inf

    def ms_of(res):
        return lups / res.score / 1e6

    got = ttune.autotune(spec, grid, measure=scorer, max_evals=12,
                         d_w_cap=512)
    dw8nf2 = K1_MS_7PT_VAR_512[(8, 2)]
    assert ms_of(got) <= dw8nf2
    assert fields(got.evaluated[0][0]) == fields(tmwd.MWDPlan())
    analytic = ttune.model_score(spec, grid)
    with um.patch.object(rmodels, "vmem_fits",
                         lambda s, d_w, n_f, *a, **k: tmodels.smem_fits(
                             spec, d_w, n_f, 512)), \
            um.patch.object(rtune, "model_score",
                            lambda *a, **k: analytic):
        old = rtune.autotune(rst.SPECS["7pt-var"], grid, measure=scorer,
                             max_evals=12, d_w_cap=512)
    assert (old.plan.d_w, old.plan.n_f) == (14, 2)
    assert ms_of(old) > dw8nf2
    assert (8, 2, True) not in {(p.d_w, p.n_f, p.fused)
                                for p, _ in old.evaluated}
