"""Stencil request-queue server on the port's MWD kernel.

  python -m repro_torch.launch.serve --stencil 7pt-var --grid 512,512,512 \\
      --requests 4 --steps 8 --max-batch 2

The port of the stencil half of `repro.launch.serve`: each request asks to
advance its own grid N time steps. Requests are bucketed by operator
fingerprint, grid shape, dtype, step count and scalar coefficients; when a
request reaches the head of the two-lane queue the server waits at most
`--batch-window-ms` for up to `--max-batch` same-bucket arrivals, then
advances the whole batch with one `ops.mwd_batched` call (one kernel launch
per diamond row for all B grids). Telemetry (`--telemetry stdout` or
``jsonl:<path>``) reports per-bucket throughput, queue depth and rolling
latency percentiles.

Plans resolve registry-first per (class, batch size) under the ``b<B>``
key (`core.registry`; ``--registry PATH`` names the file, ``--spec`` the
device spec the model prices against). Only exact padding classes are
served so far: a ragged ladder (``pow2``, rungs) needs the frozen-halo
masking that is not ported yet and is refused. Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import ir, padding, precision, scheduler
from repro_torch.core import registry as reg
from repro_torch.core import specs as devspecs
from repro_torch.core import stencils as stc
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import telemetry as tlm


@dataclasses.dataclass(eq=False)        # identity equality: fields hold tensors
class StencilRequest:
    """One user request: advance my resident grid `n_steps` time steps.

    `priority` picks the queue lane (``"interactive"`` is always drained
    first); `deadline_s` — like `arrival_s` an offset from server start —
    lets the window policy close a batch early (`math.inf`: no deadline).
    """

    rid: int
    spec: object                # StencilOp
    state: tuple                # (cur, prev)
    coeffs: object              # the op's packed coefficients
    n_steps: int
    arrival_s: float = 0.0
    priority: str = "batch"
    deadline_s: float = math.inf


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Admission-control verdict: queue full, retry after `retry_after_s`."""

    retry_after_s: float


def bucket_key(spec, state, coeffs, n_steps: int, ladder=None) -> tuple:
    """Batchability class of a request.

    Requests may share one batched launch iff they agree on the operator's
    structural fingerprint, padding class (the exact shape under the exact
    ladder), dtype, step count and scalar coefficients.
    """
    lad = padding.parse_ladder(ladder)
    _, scalars = ir.split_coeffs(spec, coeffs)
    cur = state[0]
    return (spec.fingerprint, lad.padded_shape(cur.shape),
            precision.dtype_name(cur.dtype), n_steps,
            tuple(float(x) for x in scalars))


def _require_exact(ladder) -> padding.PaddingLadder:
    lad = padding.parse_ladder(ladder)
    if lad.mode != "exact":
        raise NotImplementedError(
            f"padding ladder {lad.mode!r}: only exact classes are served "
            "until the frozen-halo masking is ported")
    return lad


def _resolve(spec, plan, batch: int, shape, word: int, registry=None):
    """``(MWDPlan, plan_source)`` of a launch of `batch` grids of `shape`.

    ``"auto"`` resolves in `registry` (default: `reg.default_registry`);
    the source is the registry's (``registry:measured``, ``model``, ...).
    """
    if plan == "auto":
        registry = registry or reg.default_registry()
        return registry.resolve(spec, tuple(shape), word_bytes=word,
                                devices_x=1, batch=batch)
    return plan, "explicit"


def _launch_batch(spec, states, coeffs_list, n_steps, plan, padded_shape,
                  registry=None):
    """One batched MWD advance of exact-fit grids.

    Every grid must already have the class shape: ragged batches need the
    frozen-halo masking that the port does not have yet, so they raise.
    Returns ``(per-request (cur, prev) list, plan, plan_source)``; the
    results are on the device when this returns.
    """
    shapes = [tuple(s[0].shape) for s in states]
    if any(sh != tuple(padded_shape) for sh in shapes):
        raise NotImplementedError(
            f"{spec.name}: ragged batch {shapes} in class {padded_shape}; "
            "padding classes other than exact are not ported yet")
    plan, source = _resolve(spec, plan, len(states), padded_shape,
                            states[0][0].element_size(), registry)
    cur, prev = ops.mwd_batched(spec, list(states), list(coeffs_list),
                                n_steps, plan=plan)
    if cur.is_cuda:
        torch.cuda.synchronize(cur.device)
    return [(cur[i], prev[i]) for i in range(len(states))], plan, source


def serve_queue(requests, *, max_batch: int = 4, batch_window_ms: float = 5.0,
                plan="auto", ladder=None, admission=None, telemetry=None,
                registry=None):
    """Continuous-batching serving loop over `requests`.

    Arrivals are admitted into a two-lane bounded queue; offers past the
    admission watermark become `Rejected` results. When a request reaches
    the head, the server collects every admitted same-bucket request and
    waits — at most `batch_window_ms` past the head's service start, closed
    early by the head's deadline — while the batch is short of `max_batch`;
    the batch then advances in one `ops.mwd_batched` call.

    Returns ``(results, records)``: ``results[rid]`` is the request's
    ``(cur, prev)`` or `Rejected`, and one record dict per batch
    (``rids, size, key, done_s, launch_s, lane, padded_shape, waste, plan,
    plan_source``). `registry` is where ``plan="auto"`` resolves (default:
    the process default registry). The launch-time estimator's dispatch
    is the device spec's measured `launch_s`.
    """
    lad = _require_exact(ladder)
    tele = tlm.make_telemetry(telemetry)
    own_tele = not isinstance(telemetry, tlm.Telemetry)
    queue = scheduler.LaneQueue(admission or scheduler.AdmissionPolicy())
    est = scheduler.ServiceEstimator(
        dispatch_s=devspecs.current_spec().launch_s)
    agg = tlm.Aggregator()
    pending = sorted(requests, key=lambda r: r.arrival_s)
    keys = {id(r): bucket_key(r.spec, r.state, r.coeffs, r.n_steps,
                              ladder=lad)
            for r in pending}
    results: dict[int, object] = {}
    records: list[dict] = []
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    def admit_upto(t: float) -> None:
        while pending and pending[0].arrival_s <= t:
            r = pending.pop(0)
            retry = queue.offer(r, r.priority)
            if retry is None:
                tele.emit("admit", rid=r.rid, lane=r.priority,
                          queue_depth=queue.depth())
            else:
                results[r.rid] = Rejected(retry_after_s=retry)
                agg.on_reject()
                tele.emit("reject", rid=r.rid, lane=r.priority,
                          retry_after_s=retry, queue_depth=queue.depth())

    while pending or len(queue):
        if not len(queue):
            time.sleep(max(0.0, pending[0].arrival_s - now()))
        admit_upto(now())
        if queue.head() is None:
            continue
        head, lane = queue.head()
        key = keys[id(head)]
        close = scheduler.window_close_s(
            now(), batch_window_ms / 1e3, deadline_s=head.deadline_s,
            predicted_launch_s=est.predict(key, max_batch))
        while True:
            admit_upto(now())
            mates = [r for r in queue.items() if keys[id(r)] == key]
            if len(mates) >= max_batch:
                mates = mates[:max_batch]
                break
            upcoming = [r for r in pending
                        if keys[id(r)] == key and r.arrival_s <= close]
            if not upcoming:
                break
            time.sleep(max(0.0, upcoming[0].arrival_s - now()))
        batch = mates
        queue.remove(batch)

        t_launch = time.perf_counter()
        outs, plan_used, source = _launch_batch(
            head.spec, [r.state for r in batch], [r.coeffs for r in batch],
            head.n_steps, plan, key[1], registry)
        launch_s = time.perf_counter() - t_launch
        done = now()
        est.observe(key, len(batch), launch_s)
        shapes = [tuple(r.state[0].shape) for r in batch]
        waste = padding.padding_waste(shapes, key[1])
        agg.on_launch(key, len(batch), launch_s,
                      padded_cells=len(batch) * math.prod(key[1]),
                      real_cells=sum(math.prod(s) for s in shapes),
                      plan_source=source)
        for r, out in zip(batch, outs):
            results[r.rid] = out
            agg.on_done(done - r.arrival_s,
                        deadline_missed=done > r.deadline_s)
        records.append({"rids": [r.rid for r in batch], "size": len(batch),
                        "key": key, "done_s": done, "launch_s": launch_s,
                        "lane": lane, "padded_shape": key[1], "waste": waste,
                        "plan": plan_used, "plan_source": source})
        roll = agg.latency.summary()
        tele.emit("launch", key=str(key), size=len(batch), lane=lane,
                  launch_s=launch_s, waste=waste, plan_source=source,
                  queue_depth=queue.depth(), done_s=done,
                  p50_ms=roll["p50"] * 1e3, p99_ms=roll["p99"] * 1e3)
    tele.emit("summary", **agg.snapshot())
    if own_tele:
        tele.close()
    return results, records


def serve_stencil(name: str, grid, n_steps: int, n_requests: int, *,
                  max_batch: int = 4, batch_window_ms: float = 5.0,
                  arrival_ms: float = 1.0, seed: int = 0, pad=None,
                  telemetry=None, interactive_every: int = 0,
                  deadline_ms: float | None = None,
                  max_queue_depth: int | None = None, plan="auto",
                  dtype=None, device="cuda", registry=None):
    """Stencil-advance request-queue server: continuous batching over MWD.

    `name` is any operator `ir.resolve_op` knows. `grid` is one Z,Y,X shape
    or a list of shapes (requests cycle through them; each shape is its own
    class). `n_requests` requests — request i made by `make_problem` with
    seed ``seed + i`` on `device`, arriving `arrival_ms` apart — are served
    through `serve_queue`. Every `interactive_every`-th request (0 = none)
    rides the interactive lane with a `deadline_ms` SLO; `max_queue_depth`
    bounds admission. `plan` is ``"auto"`` (`ops.resolve_plan`) or an
    explicit `MWDPlan` applied to every launch; `registry` is where
    ``"auto"`` resolves (default: the process default registry).

    Every batch size the queue can form is launched once before serving,
    so the kernel build and first launches stay out of the latency figures.

    Returns a report dict (plan, source, results, the requests served,
    per-batch records, latency percentiles, GLUP/s, batch sizes,
    rejections, deadline misses).
    """
    spec = ir.resolve_op(name)
    dev = resolve_device(device)
    grids = ([tuple(g) for g in grid]
             if grid and isinstance(grid[0], (tuple, list))
             else [tuple(grid)] if grid else [reg.default_grid(spec)])
    ladder = _require_exact(pad)
    dt = precision.parse_dtype(dtype) if dtype is not None else None
    problems = [stc.make_problem(spec, grids[i % len(grids)], dtype=dt,
                                 seed=seed + i, device=dev)
                for i in range(n_requests)]
    classes: dict[tuple, list] = {}
    for p in problems:
        classes.setdefault(ladder.padded_shape(p[0][0].shape), []).append(p)
    head_plan, source = _resolve(spec, plan, max(1, max_batch),
                                 next(iter(classes)),
                                 problems[0][0][0].element_size(), registry)
    print(f"serving {spec.name} on {dev} in {len(classes)} class(es) "
          f"{sorted(classes)}: plan=dw{head_plan.d_w}.nf{head_plan.n_f}."
          f"{'fused' if head_plan.fused else 'row'} ({source}); "
          f"max_batch={max_batch} window={batch_window_ms}ms pad={ladder.mode}")

    for cls, members in classes.items():
        for b in range(1, min(max_batch, len(members)) + 1):
            _launch_batch(spec, [members[0][0]] * b, [members[0][1]] * b,
                          n_steps, plan, cls, registry)

    requests = [
        StencilRequest(
            rid=i, spec=spec, state=problems[i][0], coeffs=problems[i][1],
            n_steps=n_steps, arrival_s=i * arrival_ms / 1e3,
            priority=("interactive" if interactive_every
                      and i % interactive_every == 0 else "batch"),
            deadline_s=(i * arrival_ms / 1e3 + deadline_ms / 1e3
                        if deadline_ms is not None and interactive_every
                        and i % interactive_every == 0 else math.inf))
        for i in range(n_requests)]
    admission = (scheduler.AdmissionPolicy(max_depth=max_queue_depth)
                 if max_queue_depth else None)
    t_start = time.perf_counter()
    results, records = serve_queue(requests, max_batch=max_batch,
                                   batch_window_ms=batch_window_ms,
                                   plan=plan, ladder=ladder,
                                   admission=admission, telemetry=telemetry,
                                   registry=registry)
    t_wall = time.perf_counter() - t_start

    done_by_rid = {rid: rec["done_s"] for rec in records
                   for rid in rec["rids"]}
    served = [r for r in requests if r.rid in done_by_rid]
    rejected = [r for r in requests if isinstance(results.get(r.rid), Rejected)]
    misses = sum(done_by_rid[r.rid] > r.deadline_s for r in served)
    lat = sorted(done_by_rid[r.rid] - r.arrival_s for r in served)
    p50, p95, p99 = (np.percentile(lat, [50, 95, 99]) if lat
                     else (0.0, 0.0, 0.0))
    lups = sum(float(np.prod(r.state[0].shape)) * n_steps for r in served)
    glups = lups / t_wall / 1e9
    sizes = [rec["size"] for rec in records]
    print(f"served {len(served)}/{n_requests} requests x {n_steps} steps in "
          f"{len(records)} batches (sizes {sizes}): "
          f"p50 {p50*1e3:.1f}ms p95 {p95*1e3:.1f}ms p99 {p99*1e3:.1f}ms, "
          f"agg {glups:.4f} GLUP/s; rejected={len(rejected)} "
          f"deadline_misses={misses}")
    return {"plan": head_plan, "source": source, "results": results,
            "requests": requests, "records": records, "latencies_s": lat, "p50_ms": p50 * 1e3,
            "p95_ms": p95 * 1e3, "p99_ms": p99 * 1e3, "glups": glups,
            "batch_sizes": sizes, "served": len(served),
            "rejected": len(rejected), "deadline_misses": misses,
            "wall_s": t_wall, "device": str(dev),
            "classes": {str(c): len(m) for c, m in classes.items()}}


def build_parser() -> argparse.ArgumentParser:
    """CLI of the stencil server (split out so tests can parse args)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--stencil", required=True,
                    help="a paper op, a registered custom op, or "
                         "module.path:ATTR")
    ap.add_argument("--op-module", default=None,
                    help="import this module first (it registers custom "
                         "StencilOps via repro_torch.core.ir.register)")
    ap.add_argument("--grid", type=str, default=None,
                    help="Z,Y,X stencil grid, or several separated by ';'")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4,
                    help="time steps advanced per request")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="max requests advanced by one batched call")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="max wait for same-class arrivals before launching")
    ap.add_argument("--arrival-ms", type=float, default=1.0,
                    help="synthetic inter-arrival gap between requests")
    ap.add_argument("--pad", default="exact",
                    help="padding ladder; only 'exact' is served so far")
    ap.add_argument("--dtype", default=None,
                    help="stream dtype of every request (f32/bf16/fp16)")
    ap.add_argument("--telemetry", default=None,
                    help="live telemetry sink: 'stdout' or 'jsonl:<path>'")
    ap.add_argument("--interactive-every", type=int, default=0,
                    help="every Nth request rides the interactive lane")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="SLO deadline for interactive-lane requests")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission bound per lane")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--registry", default=None,
                    help=f"plan registry path (default ${reg.ENV_VAR} or "
                         f"{reg.DEFAULT_PATH})")
    ap.add_argument("--spec", default=None,
                    help="device spec name or spec-file path plan "
                         "resolution prices against (default: "
                         f"${devspecs.ENV_SPEC} or "
                         f"{devspecs.DEFAULT_SPEC_NAME})")
    return ap


def main(argv=None):
    """CLI entry point: the stencil request-queue server."""
    args = build_parser().parse_args(argv)
    if args.spec:
        devspecs.set_default_spec(args.spec)
    if args.op_module:
        import importlib
        importlib.import_module(args.op_module)
    grid = ([tuple(int(x) for x in g.split(","))
             for g in args.grid.split(";")] if args.grid else None)
    if grid and len(grid) == 1:
        grid = grid[0]
    serve_stencil(args.stencil, grid, args.steps, args.requests,
                  max_batch=args.max_batch,
                  batch_window_ms=args.batch_window_ms,
                  arrival_ms=args.arrival_ms, pad=args.pad,
                  telemetry=args.telemetry,
                  interactive_every=args.interactive_every,
                  deadline_ms=args.deadline_ms,
                  max_queue_depth=args.max_queue_depth,
                  dtype=args.dtype, device=args.device,
                  registry=(reg.PlanRegistry(args.registry) if args.registry
                            else None))


if __name__ == "__main__":
    main()
