"""Sustained mixed-traffic soak through the ragged serving tier.

  python -m repro_torch.launch.soak [--device cpu] [--report PATH]
  python -m repro_torch.launch.soak_report PATH --max-p99-ms 2500 \\
      --max-dropped 0 --min-throughput-ratio 1.0

The port of the ``soak`` bench of ``benchmarks/run.py``, with the same mix:
24 requests of 2 steps on 7pt-var (per-cell coefficients, so the masked
operator is the op itself and the padded launch runs the very kernel the
unbatched baseline runs), grids (6, 10, 8) and (6, 12, 10) alternating,
which the ladder "6,8,12" puts in two ragged classes; seeded exponential
arrivals 1.5 ms apart on average; every 3rd request on the interactive lane
with a 2 s deadline; at most 4 requests a batch within a 10 ms window.

Checks, each raising `SoakFailed`: every response equals its own
`ops.mwd` run under the soak's plan (``torch.equal``: a frozen ``-0.0``
on the boundary ring would read as ``+0.0``, see `core.padding`); no
request is dropped; draining the whole mix with batching on beats
draining it one request a launch (best of 5 rounds each, the two taken in
turns; on one intra-op thread on the CPU, see `contest`).

The JSON report (the reference's keys) goes to `$REPRO_TORCH_SOAK_REPORT`,
else ``.repro_torch_cache/soak.json``; the JSON-lines telemetry events go
beside it. `run_mix` runs the mix and its correctness checks alone, with
no wall-clock contest; `finish` adds the contest and writes the report. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import padding
from repro_torch.core import stencils as stc
from repro_torch.core.mwd import MWDPlan
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import stencil_mwd as sm
from repro_torch.launch import serve

ENV_REPORT = "REPRO_TORCH_SOAK_REPORT"
DEFAULT_REPORT = os.path.join(".repro_torch_cache", "soak.json")

OP = "7pt-var"
GRIDS = ((6, 10, 8), (6, 12, 10))
N_REQUESTS, N_STEPS, SEED = 24, 2, 0
PLAN = MWDPlan(d_w=4, n_f=2)
LADDER = "6,8,12"               # classes (6, 12, 8) and (6, 12, 12)
MEAN_GAP_S = 1.5e-3
INTERACTIVE_EVERY, DEADLINE_S = 3, 2.0
MAX_BATCH, WINDOW_MS, DRAIN_WINDOW_MS = 4, 10.0, 5.0
CONTEST_ROUNDS = 5


class SoakFailed(RuntimeError):
    """A soak check did not hold."""


def report_path() -> str:
    """Where the report goes: `$REPRO_TORCH_SOAK_REPORT` or the default."""
    return os.environ.get(ENV_REPORT) or DEFAULT_REPORT


def run_mix(device="cuda", events_path: str | None = None):
    """Serve the soak mix once and check it.

    Warms every (class, batch size, exact or masked) launch first, then
    serves the seeded arrivals through `serve.serve_queue` with telemetry
    to `events_path` (JSON lines; none if None). Raises `SoakFailed` if a
    response differs from its own `ops.mwd` or a request was dropped.
    Returns ``(report fields, problems, launches)``: the problems for the
    throughput contest to reuse, and the K1 launches of the serving run
    alone (neither the warm-up nor the checks; 0 on the CPU, where K1's
    plain version runs).
    """
    dev = resolve_device(device)
    spec = stc.SPECS[OP]
    problems = [stc.make_problem(spec, GRIDS[i % len(GRIDS)], seed=SEED + i,
                                 device=dev)
                for i in range(N_REQUESTS)]
    ladder = padding.parse_ladder(LADDER)
    classes = serve.padding_classes(problems, ladder)
    if len(classes) < 2:
        raise SoakFailed(f"the soak mix must span >= 2 classes: {classes}")
    serve.warm(spec, classes, MAX_BATCH, N_STEPS, PLAN)

    arrivals = np.cumsum(np.random.default_rng(SEED).exponential(
        MEAN_GAP_S, N_REQUESTS))
    interactive = [i % INTERACTIVE_EVERY == 0 for i in range(N_REQUESTS)]
    requests = [serve.StencilRequest(
        rid=i, spec=spec, state=problems[i][0], coeffs=problems[i][1],
        n_steps=N_STEPS, arrival_s=float(arrivals[i]),
        priority="interactive" if interactive[i] else "batch",
        deadline_s=(float(arrivals[i]) + DEADLINE_S if interactive[i]
                    else float("inf")))
        for i in range(N_REQUESTS)]
    launched = sm.LAUNCHES.count
    t0 = time.perf_counter()
    results, records = serve.serve_queue(
        requests, max_batch=MAX_BATCH, batch_window_ms=WINDOW_MS, plan=PLAN,
        ladder=ladder,
        telemetry=f"jsonl:{events_path}" if events_path else None)
    wall = time.perf_counter() - t0
    launched = sm.LAUNCHES.count - launched

    dropped = sum(isinstance(v, serve.Rejected) for v in results.values())
    bitwise_ok = True
    for r in requests:
        if isinstance(results.get(r.rid), serve.Rejected):
            continue
        want = ops.mwd(spec, r.state, r.coeffs, N_STEPS, plan=PLAN)
        if not all(torch.equal(g, w) for g, w in zip(results[r.rid], want)):
            bitwise_ok = False
    if not bitwise_ok:
        raise SoakFailed("a padded batched response differs from its own "
                         "ops.mwd run")
    if dropped:
        raise SoakFailed(f"{dropped} requests dropped")

    summ = serve.queue_summary(requests, records)
    return {
        "bench": "soak", "op": spec.name, "seed": SEED,
        "grids": [list(g) for g in GRIDS],
        "classes": {str(c): len(m) for c, m in classes.items()},
        "n_requests": N_REQUESTS, "served": len(summ["served"]),
        "dropped": dropped, "bitwise_ok": bitwise_ok,
        "deadline_misses": int(summ["deadline_misses"]),
        "p50_ms": summ["p50_ms"], "p95_ms": summ["p95_ms"],
        "p99_ms": summ["p99_ms"], "wall_s": wall,
        "batch_sizes": summ["batch_sizes"],
        "padding_waste": summ["padding_waste"],
        "plan": f"dw{PLAN.d_w}.nf{PLAN.n_f}"}, problems, launched


def contest(problems) -> tuple[float, float]:
    """Seconds to drain the whole mix, batching off and on: ``(t_seq,
    t_bat)``, each the best of `CONTEST_ROUNDS`, the two drains taken in turns
    within each round so that a load spike from other processes hits both.
    Every request has arrived before the drain starts, so the wall clock is
    serving throughput, not arrival pacing.

    On the CPU both drains run on one intra-op thread (`single_thread`):
    with the default pool, other processes holding the cores slow the
    batched drain's larger, threaded ops several-fold and leave the
    sequential drain's small single-threaded ops alone, so the contest
    would read the machine's load instead of batching.
    """
    spec = stc.SPECS[OP]
    ladder = padding.parse_ladder(LADDER)

    def drain(max_batch, lad):
        reqs = [serve.StencilRequest(rid=i, spec=spec, state=p[0],
                                     coeffs=p[1], n_steps=N_STEPS)
                for i, p in enumerate(problems)]
        t = time.perf_counter()
        serve.serve_queue(reqs, max_batch=max_batch,
                          batch_window_ms=DRAIN_WINDOW_MS, plan=PLAN,
                          ladder=lad)
        return time.perf_counter() - t

    with single_thread(problems[0][0][0].device):
        for p in problems[:len(GRIDS)]:  # warm the B=1 exact-shape launches
            serve._launch_batch(spec, [p[0]], [p[1]], N_STEPS, PLAN,
                                tuple(p[0][0].shape))
        drain(MAX_BATCH, ladder), drain(1, None)   # warm the loop
        t_bat, t_seq = [], []
        for _ in range(CONTEST_ROUNDS):
            t_bat.append(drain(MAX_BATCH, ladder))
            t_seq.append(drain(1, None))
    return min(t_seq), min(t_bat)


@contextlib.contextmanager
def single_thread(device: torch.device):
    """One intra-op thread while inside, on a CPU device; the pool's size
    comes back after. A no-op for a CUDA device."""
    if device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def events_path(path: str) -> str:
    """The JSON-lines events file beside the report at `path`, made fresh
    (its directory created, an old file removed)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    events = path + ".events.jsonl"
    if os.path.exists(events):
        os.unlink(events)
    return events


def run_soak(device="cuda", path: str | None = None) -> dict:
    """The mix, its checks and the throughput contest; writes the report.

    Raises `SoakFailed` when a check fails, and then writes no report.
    """
    path = path or report_path()
    events = events_path(path)
    report, problems, _ = run_mix(device, events)
    return finish(report, problems, path, events)


def finish(report, problems, path: str, events: str) -> dict:
    """`run_mix`'s report through the throughput contest, written to
    `path`; raises `SoakFailed`, writing nothing, if batching lost."""
    t_seq, t_bat = contest(problems)
    ratio = t_seq / t_bat
    if ratio < 1.0:
        raise SoakFailed(f"batched serving throughput below sequential: "
                         f"{t_bat * 1e3:.1f}ms vs {t_seq * 1e3:.1f}ms to "
                         "drain the mix")
    report.update(throughput_ratio=ratio, t_seq_s=t_seq, t_bat_s=t_bat,
                  events=events)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return report


def build_parser() -> argparse.ArgumentParser:
    """CLI of the soak (split out so tests can parse args)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.soak")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--report", default=None,
                    help=f"report path (default ${ENV_REPORT} or "
                         f"{DEFAULT_REPORT})")
    return ap


def main(argv=None) -> int:
    """Run the soak, print one summary line; 0 on success."""
    args = build_parser().parse_args(argv)
    path = args.report or report_path()
    rep = run_soak(args.device, path)
    print(f"soak {rep['op']} on {resolve_device(args.device)}: served "
          f"{rep['served']}/{rep['n_requests']} dropped={rep['dropped']} "
          f"batches={rep['batch_sizes']} waste={rep['padding_waste']:.3f} "
          f"p50 {rep['p50_ms']:.1f}ms p99 {rep['p99_ms']:.1f}ms "
          f"thr_ratio={rep['throughput_ratio']:.2f}x report={path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
