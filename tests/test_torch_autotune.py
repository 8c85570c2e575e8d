"""The port's tuner against the reference's, and its timing policy.

The search itself (`_neighbors`, the seed, the analytic climb, the
hill-climb, `max_evals`, the baseline first) is held against
`repro.core.autotune.autotune` on the same injected scorer, with each
package's fit and model monkeypatched to the same functions; the port's
own model is held to what K1 launches (`_plan_valid`, `smem_fits`).
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


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("devices_x,max_evals,cap", [(1, 64, None),
                                                     (1, 5, None),
                                                     (2, 64, 16)])
def test_search_equals_reference_on_the_same_scorer(monkeypatch, name,
                                                    devices_x, max_evals,
                                                    cap):
    rspec, tspec = pair(name)
    monkeypatch.setattr(rmodels, "vmem_fits", fit)
    monkeypatch.setattr(tmodels, "smem_fits", fit)
    monkeypatch.setattr(rtune, "model_score", lambda *a, **k: synthetic)
    monkeypatch.setattr(ttune, "model_score", lambda *a, **k: synthetic)
    calls = {"r": [], "t": []}

    def scorer(side):
        def score(plan):
            calls[side].append(fields(plan))
            return synthetic(plan)
        return score

    grid = (16, 24, 20)
    want = rtune.autotune(rspec, grid, devices_x=devices_x,
                          measure=scorer("r"), max_evals=max_evals,
                          d_w_cap=cap, prune_ratio=0.0)
    got = ttune.autotune(tspec, grid, devices_x=devices_x,
                         measure=scorer("t"), max_evals=max_evals,
                         d_w_cap=cap, prune_ratio=0.0)
    assert calls["t"] == calls["r"] and calls["t"][0] == fields(
        tmwd.MWDPlan())
    assert [(fields(p), s) for p, s in got.evaluated] == \
        [(fields(p), s) for p, s in want.evaluated]
    assert fields(got.plan) == fields(want.plan) and got.score == want.score
    assert len(got.evaluated) <= max_evals


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
    chip = ttune.devspecs.current_spec()
    for name in NAMES:
        _, spec = pair(name)
        d = ttune._seed_d_w(spec, 512, chip)
        assert tmodels.smem_fits(spec, d, 1, 512)
        assert not tmodels.smem_fits(spec, d + 2 * spec.radius, 1, 512)
        assert ttune._seed_d_w(spec, 512, chip, d_w_cap=2 * spec.radius) \
            == 2 * spec.radius


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
