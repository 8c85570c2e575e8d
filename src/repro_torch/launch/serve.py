"""Serving launcher: the LM decode loop with a KV/state cache, and the
stencil request-queue server on the port's MWD kernel.

  python -m repro_torch.launch.serve --arch llama3.2-1b --no-reduced \\
      --batch 8 --prompt-len 128 --gen 128             # on the card
  python -m repro_torch.launch.serve --device cpu --arch mamba2-130m
  python -m repro_torch.launch.serve --stencil 7pt-var \\
      --grid "512,512,512;448,480,496" --pad pow2 --requests 4 --steps 8 \\
      --max-batch 2

The port of `repro.launch.serve`. The LM half (no ``--stencil``): the
one-device mesh of the card ``--device`` names (`elastic.build_mesh`), or,
under a process group of more than one rank, `plan_mesh` over every
rank's device, the seed-0 parameters of ``--arch`` (reduced unless
``--no-reduced``) placed with `training.sharding.place` (a rank's blocks
on a process mesh, and its blocks of the cache by `cache_shardings`),
numpy-seeded prompts (a rank takes its rows), `prefill_into_cache` (the
prompt stepped through the decode path), then a greedy decode loop of
``--gen`` tokens that starts from the prompt's last token, as the
reference's does. No stencil kernel runs on it: the products are
`torch.matmul`.

The stencil half (``--stencil``): each request asks to advance its own
grid N time steps. Requests are bucketed by operator
fingerprint, padding class (the grid's per-axis rung of the ``--pad``
ladder: ``exact``, ``pow2`` or rungs such as ``8,16,32``), dtype, step
count and scalar coefficients; when a request reaches the head of the
two-lane queue the server waits at most `--batch-window-ms` for up to
`--max-batch` same-bucket arrivals, then advances the whole batch with one
`ops.mwd_batched` call (one kernel launch per diamond row for all B grids)
at the class shape. Smaller grids ride under frozen-halo masking
(`core.padding`), so every response equals its own unpadded `ops.mwd` run
under the same plan. Telemetry (`--telemetry stdout` or ``jsonl:<path>``)
reports per-bucket throughput, queue depth, padding waste and rolling
latency percentiles.

Plans resolve registry-first per (class, batch size) under the ``b<B>``
key (`core.registry`; ``--registry PATH`` names the file, ``--spec`` the
device spec the model prices against); a ragged batch resolves the masked
operator's plan. Runs on ``cuda`` unless ``--device cpu`` is given, and
raises without a GPU rather than falling back.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import ir, padding, precision, scheduler
from repro_torch.core import registry as reg
from repro_torch.core import specs as devspecs
from repro_torch.core import stencils as stc
from repro_torch.device import resolve_device
from repro_torch.distributed import elastic, process
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import telemetry as tlm
from repro_torch.models import lm
from repro_torch.training import sharding as shd
from repro_torch.training import steps as tsteps


def prefill_into_cache(cfg, params, tokens, gen: int,
                       cache_len: int | None = None, *, mesh=None):
    """Prefill by stepping the decode path (simple and exact).

    The cache, on the prompt's device, is sized for the WHOLE request:
    the prompt plus the `gen` tokens the decode loop will append. A
    caller-provided `cache_len` is guarded against overflow instead of
    trusted, with the same ``max(gen, 1)`` rule as the default sizing,
    because decode reads one slot past the prompt even when gen=0.
    Under a process `mesh` the `params` are this rank's blocks, `tokens`
    the global prompts, of which the rank steps its rows, and the cache
    is the rank's blocks by `cache_shardings`. Returns ``(last logits
    (B, 1, vocab), cache)`` (this rank's rows and vocab columns).
    """
    if gen < 0:
        raise ValueError(f"gen must be >= 0, got {gen}")
    b, s = tokens.shape
    if cache_len is None:
        cache_len = s + max(gen, 1)     # decode reads one slot past prefill
    if cache_len < s + max(gen, 1):
        raise ValueError(f"cache_len={cache_len} cannot hold the "
                         f"{s}-token prompt plus {max(gen, 1)} decode slots")
    dec = tsteps.make_decoder(cfg, b, cache_len, mesh=mesh)
    if dec.layout is None:
        cache = lm.init_cache(cfg, b, cache_len, device=tokens.device)
    else:
        cache = dec.place(lm.init_cache(cfg, b, cache_len, device="cpu"))
    tokens = dec.rows(tokens)
    logits = None
    for i in range(s):
        _, logits, cache = dec.step(params, cache, tokens[:, i:i + 1])
    return logits, cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(cfg, batch: int, prompt_len: int, gen: int,
             device=None, *, mesh=None) -> dict:
    """The LM decode loop: seed-0 parameters placed on the mesh,
    numpy-seeded prompts (``default_rng(0)``), `prefill_into_cache`, then
    `gen` greedy steps from the prompt's last token. The mesh is `mesh`
    (a process mesh), else, under a process group of more than one rank,
    `plan_mesh` over every rank's device, else the one-device mesh of
    `device`; on a process mesh each rank holds its blocks and steps its
    rows. Prints the reference's two lines (rank 0). Returns
    ``prefill_ms``, ``decode_ms`` (one host-clock time a step, each ending
    in a synchronize), ``decode_ms_per_token`` (their median),
    ``tokens_per_s`` (batch x gen over the loop's time), ``ids`` (the
    generated ``(batch, gen)`` int32 ids on the host, every rank's rows),
    and the state the loop left: ``cfg``, ``params``, ``cache`` and
    ``next`` (the last step's tokens, what a further step would take;
    this rank's blocks and rows on a process mesh)."""
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode")
    dev = resolve_device(device)
    if mesh is None and process.process_count() > 1:
        dev = process.rank_device(dev.type)
        mesh = elastic.build_mesh(devices=launch_mesh.rank_devices(dev))
    pmesh = mesh
    if mesh is None:
        mesh = elastic.build_mesh(devices=[dev])
    else:
        dev = shd.device_for(shd.NamedSharding(mesh, ()))
    specs = lm.param_specs(cfg)
    params = shd.init_blocks(specs, 0, shd.param_shardings(mesh, specs))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
            np.int32)).to(dev)

    _sync(dev)
    t0 = time.perf_counter()
    _, cache = prefill_into_cache(cfg, params, prompts, gen, mesh=pmesh)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    dec = tsteps.make_decoder(cfg, batch, prompt_len + max(gen, 1),
                              mesh=pmesh)
    toks = dec.rows(prompts[:, -1:])
    out, step_s = [], []
    for _ in range(gen):
        t0 = time.perf_counter()
        toks, _, cache = dec.step(params, cache, toks)
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        out.append(toks)
    ids = (torch.cat(out, dim=1) if out
           else torch.zeros((toks.shape[0], 0), dtype=torch.int32,
                            device=dev))
    ids = dec.whole(ids).cpu()
    t_gen = sum(step_s)
    tput = batch * gen / t_gen if t_gen else 0.0
    if process.process_index() == 0:
        print(f"prefill {batch}x{prompt_len} in {t_prefill*1e3:.0f}ms; "
              f"generated {gen} tokens/seq at {tput:.1f} tok/s "
              f"(batch={batch})")
        print("sample token ids:", ids[0][:16].tolist())
    return {"arch": cfg.name, "device": str(dev), "mesh": mesh.shape,
            "batch": batch, "prompt_len": prompt_len, "gen": gen,
            "prefill_ms": t_prefill * 1e3,
            "decode_ms": [t * 1e3 for t in step_s],
            "decode_ms_per_token": (float(np.median(step_s)) * 1e3
                                    if step_s else 0.0),
            "tokens_per_s": tput, "ids": ids, "cfg": cfg, "params": params,
            "cache": cache, "next": toks}


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
    structural fingerprint, padding class (the grid shape's per-axis ladder
    rung; the exact shape under the exact ladder), dtype, step count and
    scalar coefficients: the kernel inlines the scalars, so two requests
    with different constants never ride one launch.
    """
    lad = padding.parse_ladder(ladder)
    _, scalars = ir.split_coeffs(spec, coeffs)
    cur = state[0]
    return (spec.fingerprint, lad.padded_shape(cur.shape),
            precision.dtype_name(cur.dtype), n_steps,
            tuple(float(x) for x in scalars))


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
    """One batched MWD advance at the padding-class shape.

    An exact-fit batch (every grid already at `padded_shape`) runs `spec`
    on the members' own tensors. A ragged batch runs
    `padding.masked_variant(spec)` on the members embedded straight into
    stacked class-shape tensors (`padding.pad_batch`; the recipe is cached
    per op, so a batch signature derives nothing anew) and crops each
    response back with views; its members must share their scalar
    coefficients. ``plan="auto"`` resolves the launched op's plan under
    the ``b<B>`` key. Each response equals the member's unpadded
    `ops.mwd` under the returned plan. Returns ``(per-request (cur, prev)
    list, plan, plan_source)``; the results are on the device when this
    returns.
    """
    shapes = [tuple(s[0].shape) for s in states]
    exact = all(sh == tuple(padded_shape) for sh in shapes)
    run_spec = spec if exact else padding.masked_variant(spec)
    plan, source = _resolve(run_spec, plan, len(states), padded_shape,
                            states[0][0].element_size(), registry)
    if exact:
        cur, prev = ops.mwd_batched(spec, list(states), list(coeffs_list),
                                    n_steps, plan=plan)
        outs = [(cur[i], prev[i]) for i in range(len(states))]
    else:
        mop, stacked, packed = padding.pad_batch(spec, states, coeffs_list,
                                                 padded_shape)
        cur, prev = ops.mwd_batched(mop, stacked, packed, n_steps, plan=plan)
        outs = [padding.crop_state((cur[i], prev[i]), sh)
                for i, sh in enumerate(shapes)]
    if cur.is_cuda:
        torch.cuda.synchronize(cur.device)
    return outs, plan, source


def draw_problem(spec, grid, dtype, seed: int, device):
    """One request's seeded ``(state, coeffs)`` on `device`.

    On the CPU these are `make_problem`'s numpy draws, the reference's
    numbers; on the card `random_problem`'s draws of the same distribution
    there (seconds faster a 512^3 volume).
    """
    make = (stc.make_problem if torch.device(device).type == "cpu"
            else stc.random_problem)
    return make(spec, grid, dtype=dtype, seed=seed, device=device)


def padding_classes(problems, ladder) -> dict:
    """``(state, coeffs)`` problems grouped by their padding class."""
    lad = padding.parse_ladder(ladder)
    classes: dict[tuple, list] = {}
    for p in problems:
        classes.setdefault(lad.padded_shape(p[0][0].shape), []).append(p)
    return classes


def queue_summary(requests, records) -> dict:
    """What one `serve_queue` run's `records` say of its `requests`.

    Returns the requests served, their sorted latencies (``latencies_s``)
    and p50/p95/p99 in ms (0 when none was served), the deadline misses,
    the batch sizes and the padding waste weighted by batch size.
    """
    done_by_rid = {rid: rec["done_s"] for rec in records
                   for rid in rec["rids"]}
    served = [r for r in requests if r.rid in done_by_rid]
    lat = sorted(done_by_rid[r.rid] - r.arrival_s for r in served)
    p50, p95, p99 = (np.percentile(lat, [50, 95, 99]) if lat
                     else (0.0, 0.0, 0.0))
    sizes = [rec["size"] for rec in records]
    return {"served": served, "latencies_s": lat,
            "p50_ms": float(p50) * 1e3, "p95_ms": float(p95) * 1e3,
            "p99_ms": float(p99) * 1e3,
            "deadline_misses": sum(done_by_rid[r.rid] > r.deadline_s
                                   for r in served),
            "batch_sizes": sizes,
            "padding_waste": (sum(rec["waste"] * rec["size"]
                                  for rec in records) / max(sum(sizes), 1))}


def warm(spec, classes, max_batch, n_steps, plan, registry=None) -> None:
    """Launch every (class, batch size, exact or masked) signature once.

    `classes` maps a class shape to its members' ``(state, coeffs)``
    problems. One exact-fit member warms the plain op and one smaller
    member the masked one, at every batch size up to `max_batch` the class
    can form (window jitter makes any of them possible), so kernel builds
    and plan resolution stay out of the serving loop's latencies.
    """
    for cls, members in classes.items():
        exact = [p for p in members if tuple(p[0][0].shape) == cls]
        ragged = [p for p in members if tuple(p[0][0].shape) != cls]
        for first in (exact[:1], ragged[:1]):
            for b in (range(1, min(max_batch, len(members)) + 1) if first
                      else ()):
                _launch_batch(spec, [first[0][0]] * b, [first[0][1]] * b,
                              n_steps, plan, cls, registry)


def serve_queue(requests, *, max_batch: int = 4, batch_window_ms: float = 5.0,
                plan="auto", ladder=None, admission=None, telemetry=None,
                registry=None):
    """Continuous-batching serving loop over `requests`.

    Arrivals are admitted into a two-lane bounded queue; offers past the
    admission watermark become `Rejected` results. When a request reaches
    the head, the server collects every admitted same-bucket request and
    waits — at most `batch_window_ms` past the head's service start, closed
    early by the head's deadline — while the batch is short of `max_batch`;
    the batch then advances in one `ops.mwd_batched` call at the padding
    class's shape (`ladder`: None/"exact", "pow2" or rungs), smaller grids
    under frozen-halo masking.

    Returns ``(results, records)``: ``results[rid]`` is the request's
    ``(cur, prev)`` or `Rejected`, and one record dict per batch
    (``rids, size, key, done_s, launch_s, lane, padded_shape, waste, plan,
    plan_source``). `registry` is where ``plan="auto"`` resolves (default:
    the process default registry). The launch-time estimator's dispatch
    is the device spec's measured `launch_s`.
    """
    lad = padding.parse_ladder(ladder)
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
    or a list of shapes: requests cycle through them, and the `pad` ladder
    (None/"exact", "pow2" or rungs such as "8,16") groups them into padding
    classes, so mixed sizes share batched launches. `n_requests` requests
    (request i drawn with seed ``seed + i`` on `device`, arriving
    `arrival_ms` apart) are served through `serve_queue`. Every `interactive_every`-th request (0 = none)
    rides the interactive lane with a `deadline_ms` SLO; `max_queue_depth`
    bounds admission. `plan` is ``"auto"`` (`ops.resolve_plan`) or an
    explicit `MWDPlan` applied to every launch; `registry` is where
    ``"auto"`` resolves (default: the process default registry). Requests
    are drawn by `draw_problem`.

    Every (class, batch size, exact or masked) launch the queue can form
    runs once before serving (one exact-fit member warms the plain op, one
    smaller member the masked one), so kernel builds, plan resolution and
    first launches stay out of the latency figures.

    Returns a report dict (plan, source, results, the requests served,
    per-batch records, latency percentiles, GLUP/s over the requests' own
    cells, batch sizes, rejections, deadline misses, padding waste, the
    requests per class).
    """
    spec = ir.resolve_op(name)
    dev = resolve_device(device)
    grids = ([tuple(g) for g in grid]
             if grid and isinstance(grid[0], (tuple, list))
             else [tuple(grid)] if grid else [reg.default_grid(spec)])
    ladder = padding.parse_ladder(pad)
    dt = precision.parse_dtype(dtype) if dtype is not None else None
    problems = [draw_problem(spec, grids[i % len(grids)], dt, seed + i, dev)
                for i in range(n_requests)]
    classes = padding_classes(problems, ladder)
    head_plan, source = _resolve(spec, plan, max(1, max_batch),
                                 next(iter(classes)),
                                 problems[0][0][0].element_size(), registry)
    print(f"serving {spec.name} on {dev} in {len(classes)} class(es) "
          f"{sorted(classes)}: plan=dw{head_plan.d_w}.nf{head_plan.n_f}."
          f"{'fused' if head_plan.fused else 'row'} ({source}); "
          f"max_batch={max_batch} window={batch_window_ms}ms pad={ladder.mode}")

    warm(spec, classes, max_batch, n_steps, plan, registry)

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

    summ = queue_summary(requests, records)
    served = summ.pop("served")
    rejected = [r for r in requests if isinstance(results.get(r.rid), Rejected)]
    lups = sum(float(np.prod(r.state[0].shape)) * n_steps for r in served)
    glups = lups / t_wall / 1e9
    print(f"served {len(served)}/{n_requests} requests x {n_steps} steps in "
          f"{len(records)} batches (sizes {summ['batch_sizes']}): "
          f"p50 {summ['p50_ms']:.1f}ms p95 {summ['p95_ms']:.1f}ms "
          f"p99 {summ['p99_ms']:.1f}ms, agg {glups:.4f} GLUP/s; "
          f"rejected={len(rejected)} "
          f"deadline_misses={summ['deadline_misses']} "
          f"waste={summ['padding_waste']:.3f}")
    return {"plan": head_plan, "source": source, "results": results,
            "requests": requests, "records": records, **summ,
            "glups": glups, "served": len(served),
            "rejected": len(rejected), "wall_s": t_wall, "device": str(dev),
            "classes": {str(c): len(m) for c, m in classes.items()}}


def build_parser() -> argparse.ArgumentParser:
    """CLI of the serving launcher (split out so tests can parse args)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--stencil", default=None,
                    help="serve stencil advances instead of an LM: a paper "
                         "op, a registered custom op, or module.path:ATTR")
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
                    help="padding ladder: 'exact', 'pow2', or rungs '8,16,32'"
                         " — mixed sizes in one class share batched launches")
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
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="LM: the smoke-scale config (--no-reduced: the "
                         "published width and depth)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--backend", choices=process.BACKENDS, default=None,
                    help="LM: the process group's backend under torchrun "
                         "with more than one rank (required there)")
    ap.add_argument("--registry", default=None,
                    help=f"plan registry path (default ${reg.ENV_VAR} or "
                         f"{reg.DEFAULT_PATH})")
    ap.add_argument("--spec", default=None,
                    help="device spec name or spec-file path plan "
                         "resolution prices against (default: "
                         f"${devspecs.ENV_SPEC} or "
                         f"{devspecs.DEFAULT_SPEC_NAME})")
    return ap


def main(argv=None) -> dict:
    """CLI entry point: the stencil request-queue server (``--stencil``)
    or the LM decode loop; returns `serve_stencil`'s or `serve_lm`'s
    record."""
    args = build_parser().parse_args(argv)
    if args.spec:
        devspecs.set_default_spec(args.spec)
    if args.op_module:
        import importlib
        importlib.import_module(args.op_module)
    if not args.stencil:
        cfg = configs.get(args.arch)
        if args.reduced:
            cfg = configs.reduced(cfg)
        joined = process.join_torchrun(args.backend,
                                       resolve_device(args.device).type)
        try:
            return serve_lm(cfg, args.batch, args.prompt_len, args.gen,
                            device=args.device)
        finally:
            if joined:
                process.finalize()
    grid = ([tuple(int(x) for x in g.split(","))
             for g in args.grid.split(";")] if args.grid else None)
    if grid and len(grid) == 1:
        grid = grid[0]
    return serve_stencil(args.stencil, grid, args.steps, args.requests,
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
