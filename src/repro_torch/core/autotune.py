"""Auto-tuner (paper Sec. 4.2.2, Fig. 7): model-seeded hill climbing.

The port of `repro.core.autotune`. Flow:

  1. enumerate thread-group sizes tg_x that divide the devices along x
     (the port runs one card, so only tg_x = 1 scores: a multi-card K1
     waits for the distributed port);
  2. for each, seed at the model's best plan over every plan that fits:
     D_w in steps of 2R up to the widest D_w whose rings fit K1's shared
     memory (`models.smem_fits`, the twin of the kernel's own choice),
     every N_F dividing it, fused and per-row (`_model_seed`);
  3. hill-climb from the seed over the reference's neighbours of
     (D_w, N_F, fused), scoring with an injected measure() callback —
     `measure_score` times the real `ops.mwd` call on the card — or, by
     default, the K1 time model (`model_score`, from `models.k1_predict`).

The default `MWDPlan()` is always evaluated first, so a measured winner is
never slower than the untuned baseline; candidates predicted at less than
`prune_ratio` of the best prediction are not measured. The seed departs
from the reference, which starts at the widest D_w that fits and climbs
under the model from there: on the H100 the widest diamonds leave one CTA
per SM, and the model-only climb from them stopped in a local optimum the
measured climb could not leave (ROADMAP F2). Scoring every plan that fits
is cheap under the calibrated model, so the climb starts at its global
best.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

from repro_torch.core import models, specs as devspecs
from repro_torch.core.mwd import MWDPlan
from repro_torch.core.stencils import StencilSpec


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Winner of one auto-tuning search plus every plan it scored."""

    plan: MWDPlan
    score: float                      # higher is better (GLUP/s)
    evaluated: tuple[tuple[MWDPlan, float], ...]


def _plan_valid(spec: StencilSpec, plan: MWDPlan) -> bool:
    """Whether the MWD kernel accepts the plan (2R | D_w and N_F | D_w)."""
    return (plan.d_w % (2 * spec.radius) == 0 and plan.n_f >= 1
            and plan.d_w % plan.n_f == 0)


# steps of the advance the model prices: plan keys carry no step count, so
# the model scores the port's main path (8 steps) unless told otherwise
MODEL_STEPS = 8


def model_score(spec: StencilSpec, grid_shape, word_bytes: int = 4,
                chip: devspecs.DeviceSpec | None = None, batch: int = 1,
                n_steps: int = MODEL_STEPS) -> Callable[[MWDPlan], float]:
    """Default scorer: the K1 model's predicted GLUP/s of an `n_steps` advance.

    Plans the kernel refuses (geometry, shared memory, tg_x > 1) score
    -inf. `batch` models the batched launch (`ops.mwd_batched`): every
    term but the launches scales with B, the launches are paid once
    (`models.batch_amortized_time`). The callable is pinned to the spec
    resolved at construction.
    """
    chip = chip or devspecs.current_spec()
    nz, ny, nx = grid_shape

    def score(plan: MWDPlan) -> float:
        if (not _plan_valid(spec, plan) or plan.tg_x != 1
                or not models.smem_fits(spec, plan.d_w, plan.n_f, nx,
                                        word_bytes, chip)):
            return -math.inf
        pred = models.k1_predict(spec, grid_shape, plan.d_w, plan.n_f,
                                 n_steps, fused=plan.fused, word=word_bytes,
                                 chip=chip)
        t = models.batch_amortized_time(pred.t_total - pred.t_launch, batch,
                                        pred.t_launch)
        return batch * pred.lups / t / 1e9

    return score


def time_callable(launch: Callable[[], object], *, reps: int = 3,
                  warmup: int = 1, stat: str = "median", sync=None,
                  clock: Callable[[], float] = time.perf_counter) -> float:
    """Wall-clock seconds of `launch` over `reps` timed calls.

    THE timing policy of the port, as the reference's: `warmup` untimed
    calls (builds, the caching allocator), then the `stat` ("median" or
    "min") of `reps` `clock` intervals. Each interval ends after
    ``sync()`` returns (`torch.cuda.synchronize` for work on the card), so
    the clock stops when the device work is done, not when it was queued.
    """
    import numpy as np

    if stat not in ("median", "min"):
        raise ValueError(f"stat must be 'median' or 'min', got {stat!r}")
    sync = sync or (lambda: None)
    for _ in range(warmup):
        launch()
        sync()
    times = []
    for _ in range(reps):
        t0 = clock()
        launch()
        sync()
        times.append(clock() - t0)
    return float(np.min(times) if stat == "min" else np.median(times))


def time_callable_paired(launch_a: Callable[[], object],
                         launch_b: Callable[[], object], *, reps: int = 7,
                         warmup: int = 2, sync=None,
                         clock: Callable[[], float] = time.perf_counter
                         ) -> tuple[float, float]:
    """Min-of-reps seconds of two launches sampled in ABAB interleave.

    Both are warmed first and the timed reps alternate a/b, so drift hits
    both sides alike. Returns ``(t_a, t_b)``.
    """
    sync = sync or (lambda: None)
    for _ in range(warmup):
        launch_a()
        launch_b()
        sync()
    t_a, t_b = [], []
    for _ in range(reps):
        t0 = clock()
        launch_a()
        sync()
        t_a.append(clock() - t0)
        t0 = clock()
        launch_b()
        sync()
        t_b.append(clock() - t0)
    return float(min(t_a)), float(min(t_b))


def device_sync(tensor):
    """The `sync` of `time_callable` for work on `tensor`'s device."""
    import torch

    if tensor.is_cuda:
        return lambda: torch.cuda.synchronize(tensor.device)
    return None


def time_mwd_launch(spec: StencilSpec, states, coeffs, n_steps: int,
                    plan: MWDPlan, *, reps: int = 3, warmup: int = 1) -> float:
    """Median wall-clock seconds of ONE whole `ops.mwd` call under `plan`.

    `ops.mwd` for one problem, `ops.mwd_batched` when `states`/`coeffs`
    hold several; host side included, the clock stopped after the card is
    done (`time_callable`).
    """
    from repro_torch.kernels import ops       # deferred: core stays light

    batch = len(states)

    def launch():
        if batch > 1:
            return ops.mwd_batched(spec, states, coeffs, n_steps,
                                   d_w=plan.d_w, n_f=plan.n_f,
                                   fused=plan.fused)
        return ops.mwd(spec, states[0], coeffs[0], n_steps, d_w=plan.d_w,
                       n_f=plan.n_f, fused=plan.fused)

    return time_callable(launch, reps=reps, warmup=warmup,
                         sync=device_sync(states[0][0]))


def measure_score(spec: StencilSpec, grid_shape, word_bytes: int = 4,
                  chip: devspecs.DeviceSpec | None = None, *, n_steps: int = 4,
                  reps: int = 3, warmup: int = 1, seed: int = 0,
                  batch: int = 1, dtype=None,
                  device="cuda") -> Callable[[MWDPlan], float]:
    """Measured scorer: wall-clock GLUP/s of the real `ops.mwd` call.

    The paper's Fig. 7 measurement step: the candidate runs as the actual
    K1 advance on problems from `random_problem(..., device=device)`
    (`make_problem`'s distribution drawn on the device), timed
    as the median of `reps` calls after `warmup`. Plans the kernel refuses
    (geometry, shared memory) score -inf without being run. `batch` > 1
    times one `ops.mwd_batched` call over `batch` problems.

    The callable counts what it ran in its `measurements` attribute, which
    is how `launch.tune` proves a registry hit measured nothing.
    """
    return _MeasuredScore(spec, tuple(grid_shape), word_bytes,
                          chip or devspecs.current_spec(), n_steps, reps,
                          warmup, seed, batch, dtype, device)


@dataclasses.dataclass
class _MeasuredScore:
    """`measure_score`'s callable: it holds its problems (made at the first
    measurement) and its count, and nothing refers back to it, so the
    problems go when the search drops it."""

    spec: StencilSpec
    grid_shape: tuple
    word_bytes: int
    chip: devspecs.DeviceSpec
    n_steps: int
    reps: int
    warmup: int
    seed: int
    batch: int
    dtype: object
    device: object
    measurements: int = 0
    problems: tuple | None = None

    def __call__(self, plan: MWDPlan) -> float:
        from repro_torch.core import stencils as st

        spec, (nz, ny, nx) = self.spec, self.grid_shape
        if (not _plan_valid(spec, plan) or plan.tg_x != 1
                or not models.smem_fits(spec, plan.d_w, plan.n_f, nx,
                                        self.word_bytes, self.chip)):
            return -math.inf
        if self.problems is None:
            probs = [st.random_problem(spec, self.grid_shape,
                                       dtype=self.dtype, seed=self.seed + i,
                                       device=self.device)
                     for i in range(self.batch)]
            self.problems = ([p[0] for p in probs], [p[1] for p in probs])
        t = time_mwd_launch(spec, *self.problems, self.n_steps, plan,
                            reps=self.reps, warmup=self.warmup)
        self.measurements += 1
        return nz * ny * nx * self.n_steps * self.batch / t / 1e9


def _neighbors(plan: MWDPlan, radius: int,
               d_w_cap: int | None = None) -> list[MWDPlan]:
    step = 2 * radius
    cands = []
    for d_w in (plan.d_w - step, plan.d_w + step):
        if d_w >= step and (d_w_cap is None or d_w <= d_w_cap):
            cands.append(dataclasses.replace(plan, d_w=d_w))
    for n_f in (plan.n_f - 1, plan.n_f + 1, plan.n_f * 2):
        if n_f >= 1 and n_f != plan.n_f:
            cands.append(dataclasses.replace(plan, n_f=n_f))
    # execution mode is part of the search space
    cands.append(dataclasses.replace(plan, fused=not plan.fused))
    return cands


def _fitting_plans(spec: StencilSpec, nx: int, chip: devspecs.DeviceSpec,
                   d_w_cap: int | None = None, word_bytes: int = 4,
                   tg_x: int = 1) -> list[MWDPlan]:
    """Every plan K1 launches on grids `nx` wide: D_w in steps of 2R from
    2R up to the widest whose rings fit at N_F = 1 (or `d_w_cap`), each N_F
    dividing D_w that fits, fused then per-row."""
    step = 2 * spec.radius
    cap = 4096 if d_w_cap is None else max(step, (d_w_cap // step) * step)
    plans = []
    d_w = step
    while d_w <= cap and models.smem_fits(spec, d_w, 1, nx, word_bytes,
                                          chip):
        for n_f in range(1, d_w + 1):
            if d_w % n_f == 0 and models.smem_fits(spec, d_w, n_f, nx,
                                                   word_bytes, chip):
                plans += [MWDPlan(d_w=d_w, n_f=n_f, tg_x=tg_x, fused=fused)
                          for fused in (True, False)]
        d_w += step
    return plans


def _model_seed(analytic: Callable[[MWDPlan], float], spec: StencilSpec,
                nx: int, chip: devspecs.DeviceSpec,
                d_w_cap: int | None = None, word_bytes: int = 4,
                tg_x: int = 1) -> MWDPlan:
    """The climb's start: the best plan under `analytic` over
    `_fitting_plans` (the first of equals), or the narrowest diamond where
    none fits."""
    plans = _fitting_plans(spec, nx, chip, d_w_cap, word_bytes, tg_x)
    if not plans:
        return MWDPlan(d_w=2 * spec.radius, n_f=1, tg_x=tg_x)
    scores = [analytic(p) for p in plans]
    return plans[scores.index(max(scores))]


def autotune(spec: StencilSpec, grid_shape, devices_x: int = 1,
             measure: Callable[[MWDPlan], float] | None = None,
             chip: devspecs.DeviceSpec | None = None, word_bytes: int = 4,
             max_evals: int = 64, d_w_cap: int | None = None,
             batch: int = 1, prune_ratio: float = 0.25,
             n_steps: int = MODEL_STEPS) -> TuneResult:
    """Model-seeded local search for the best MWD plan (paper Fig. 7).

    `measure` scores candidates: `model_score` (the default) or
    `measure_score` (wall-clock on the card). The default `MWDPlan()` is
    evaluated first. Each thread group's climb starts at the model's best
    plan over every plan that fits (`_model_seed`); with an injected
    `measure`, candidates whose model score is below ``prune_ratio`` times
    the best model score seen score -inf without being measured
    (``prune_ratio=0`` measures all).
    `d_w_cap` bounds the diamond width; `max_evals` the plans scored.
    `batch` parameterizes the default model only; `n_steps` is the advance
    the model prices.
    """
    chip = chip or devspecs.current_spec()
    nz, ny, nx = grid_shape
    analytic = model_score(spec, grid_shape, word_bytes, chip, batch, n_steps)
    is_measured = measure is not None
    measure = measure or analytic
    evaluated: dict[MWDPlan, float] = {}
    analytic_ref = -math.inf          # best analytic score seen (prune ref)

    def eval_plan(plan: MWDPlan) -> float:
        nonlocal analytic_ref
        if plan in evaluated:
            return evaluated[plan]
        if len(evaluated) >= max_evals:
            return -math.inf
        if is_measured and prune_ratio > 0.0:
            a = analytic(plan)
            analytic_ref = max(analytic_ref, a)
            # the first candidate sets the reference and is never pruned
            if a < prune_ratio * analytic_ref and a < analytic_ref:
                evaluated[plan] = -math.inf
                return -math.inf
        evaluated[plan] = measure(plan)
        return evaluated[plan]

    baseline = MWDPlan()
    best: tuple[float, MWDPlan] = (eval_plan(baseline), baseline)

    tg_sizes = [d for d in range(1, devices_x + 1) if devices_x % d == 0]
    for tg in tg_sizes:
        seed = _model_seed(analytic, spec, nx // tg, chip, d_w_cap,
                           word_bytes, tg)
        cur, cur_score = seed, eval_plan(seed)
        while True:
            improved = False
            for cand in _neighbors(cur, spec.radius, d_w_cap):
                s = eval_plan(cand)
                if s > cur_score:
                    cur, cur_score, improved = cand, s, True
            if not improved:
                break
        if cur_score > best[0]:
            best = (cur_score, cur)

    return TuneResult(plan=best[1], score=best[0],
                      evaluated=tuple(evaluated.items()))
