"""Auto-tuner (paper Sec. 4.2.2, Fig. 7): model-pruned hill climbing.

The port of `repro.core.autotune`. Flow, as the reference's:

  1. enumerate thread-group sizes tg_x that divide the devices along x
     (the port runs one card, so only tg_x = 1 scores: a multi-card K1
     waits for the distributed port);
  2. for each, hill-climb over (D_w, N_F, fused) from the widest D_w whose
     rings fit K1's shared memory (`models.smem_fits`, the twin of the
     kernel's own choice);
  3. score with an injected measure() callback — `measure_score` times the
     real `ops.mwd` call on the card — or, by default, the K1 time model
     (`model_score`, from `models.k1_predict`).

The default `MWDPlan()` is always evaluated first, so a measured winner is
never slower than the untuned baseline. Measured searches use the model
twice: a free hill-climb positions the seed, and candidates predicted at
less than `prune_ratio` of the best prediction are not measured.
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
    K1 advance on problems from `make_problem(..., device=device)`, timed
    as the median of `reps` calls after `warmup`. Plans the kernel refuses
    (geometry, shared memory) score -inf without being run. `batch` > 1
    times one `ops.mwd_batched` call over `batch` problems.

    The callable counts what it ran in its `measurements` attribute, which
    is how `launch.tune` proves a registry hit measured nothing.
    """
    from repro_torch.core import stencils as st

    chip = chip or devspecs.current_spec()
    nz, ny, nx = grid_shape
    problems: list = []

    def score(plan: MWDPlan) -> float:
        if (not _plan_valid(spec, plan) or plan.tg_x != 1
                or not models.smem_fits(spec, plan.d_w, plan.n_f, nx,
                                        word_bytes, chip)):
            return -math.inf
        if not problems:
            probs = [st.make_problem(spec, (nz, ny, nx), dtype=dtype,
                                     seed=seed + i, device=device)
                     for i in range(batch)]
            problems.extend(([p[0] for p in probs], [p[1] for p in probs]))
        t = time_mwd_launch(spec, problems[0], problems[1], n_steps, plan,
                            reps=reps, warmup=warmup)
        score.measurements += 1
        return nz * ny * nx * n_steps * batch / t / 1e9

    score.measurements = 0
    return score


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


def _seed_d_w(spec: StencilSpec, nx: int, chip: devspecs.DeviceSpec,
              d_w_cap: int | None = None, word_bytes: int = 4) -> int:
    """Largest D_w whose rings fit K1 at n_f = 1 — the search's start.

    Stops at the first width that does not fit (wider ones only grow).
    """
    step = 2 * spec.radius
    cap = 4096 if d_w_cap is None else max(step, (d_w_cap // step) * step)
    d_w = step
    while d_w + step <= cap and models.smem_fits(spec, d_w + step, 1, nx,
                                                 word_bytes, chip):
        d_w += step
    return d_w


def _analytic_climb(analytic: Callable[[MWDPlan], float], seed: MWDPlan,
                    radius: int, d_w_cap: int | None = None,
                    budget: int = 128) -> tuple[MWDPlan, float]:
    """Free hill-climb under the model only; returns (plan, score)."""
    scored: dict[MWDPlan, float] = {}

    def ev(plan: MWDPlan) -> float:
        if plan not in scored and len(scored) < budget:
            scored[plan] = analytic(plan)
        return scored.get(plan, -math.inf)

    cur, cur_score = seed, ev(seed)
    while True:
        improved = False
        for cand in _neighbors(cur, radius, d_w_cap):
            s = ev(cand)
            if s > cur_score:
                cur, cur_score, improved = cand, s, True
        if not improved:
            break
    return cur, cur_score


def autotune(spec: StencilSpec, grid_shape, devices_x: int = 1,
             measure: Callable[[MWDPlan], float] | None = None,
             chip: devspecs.DeviceSpec | None = None, word_bytes: int = 4,
             max_evals: int = 64, d_w_cap: int | None = None,
             batch: int = 1, prune_ratio: float = 0.25,
             n_steps: int = MODEL_STEPS) -> TuneResult:
    """Model-pruned local search for the best MWD plan (paper Fig. 7).

    `measure` scores candidates: `model_score` (the default) or
    `measure_score` (wall-clock on the card). The default `MWDPlan()` is
    evaluated first. With an injected `measure`, a free hill-climb under
    the model positions each thread group's seed, and candidates whose
    model score is below ``prune_ratio`` times the best model score seen
    score -inf without being measured (``prune_ratio=0`` measures all).
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
        seed = MWDPlan(d_w=_seed_d_w(spec, nx // tg, chip, d_w_cap,
                                     word_bytes), n_f=1, tg_x=tg)
        if is_measured:
            seed, _ = _analytic_climb(analytic, seed, spec.radius, d_w_cap)
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
