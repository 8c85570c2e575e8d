"""Measured auto-tuning CLI: search once, persist, reuse.

  python -m repro_torch.launch.tune --stencil 7pt-const \\
      --grid 512,512,512 --steps 8 --max-evals 12          # on the card
  python -m repro_torch.launch.tune --device cpu --max-evals 6  # CPU, tiny
  python -m repro_torch.launch.tune --model-only            # no timing

The port of `repro.launch.tune`. Runs the paper's Fig. 7 auto-tuner with
real measurements — each surviving candidate plan runs and is timed as a
whole `ops.mwd` call (K1 on the card, its plain version on the CPU),
model-pruned first, median of `--reps`, fused and per-row modes both in the
search space — and writes the winner into the port's plan registry
(`core.registry`). `ops.mwd(plan="auto")` and the server resolve
registry-first, so a second run for the same (stencil, grid, hardware
fingerprint) performs zero measurements.

Output: one ``stencil,source,plan,score,measurements,evals,seconds`` row
per stencil. ``--expect-cached`` exits 3 if anything was measured.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.core import autotune, ir, precision, registry as reg
from repro_torch.core import specs as devspecs
from repro_torch.core import stencils as st


def tune_one(spec: st.StencilSpec, grid_shape, registry: reg.PlanRegistry, *,
             word_bytes: int | None = None, devices_x: int = 1,
             measured: bool = True, max_evals: int = 12, reps: int = 3,
             n_steps: int = 4, force: bool = False, batch: int = 1,
             dtype=None, device="cuda") -> dict:
    """Tune one (stencil, grid) problem registry-first; returns a report.

    On a registry hit (same key, same hardware fingerprint) nothing is
    measured and the cached plan comes back with ``source="cached"``. A
    measured run accepts only measured entries: a model entry for the same
    key is re-tuned. Otherwise the model-pruned search runs — timed on
    `device` when `measured`, model-scored when not — and the winner is
    persisted. `batch` > 1 tunes one `ops.mwd_batched` call over `batch`
    problems under the ``b<batch>`` key; `dtype` tunes that stream dtype
    under its ``w<word>`` key.

    The report holds ``stencil, source, plan, score, measurements, evals,
    seconds`` and, for a search, ``evaluated``: every plan scored, in
    order, with its score (GLUP/s; -inf where pruned or refused).
    """
    if word_bytes is None:
        word_bytes = precision.word_bytes(dtype)
    if not force:
        entry = registry.get(spec, grid_shape, word_bytes, devices_x, batch)
        if entry is not None and measured and entry.source != "measured":
            entry = None            # model-cached: upgrade with measurement
        if entry is not None:
            return {"stencil": spec.name, "source": "cached",
                    "plan": entry.plan, "score": entry.score,
                    "measurements": 0, "evals": entry.evals, "seconds": 0.0}

    ny = grid_shape[1]
    t0 = time.perf_counter()
    if measured:
        scorer = autotune.measure_score(
            spec, grid_shape, word_bytes, n_steps=n_steps, reps=reps,
            batch=batch, device=device,
            dtype=precision.parse_dtype(dtype) if dtype is not None else None)
        res = autotune.autotune(spec, grid_shape, devices_x=devices_x,
                                measure=scorer, word_bytes=word_bytes,
                                max_evals=max_evals, d_w_cap=ny,
                                n_steps=n_steps)
        n_meas, source = scorer.measurements, "measured"
    else:
        res = autotune.autotune(spec, grid_shape, devices_x=devices_x,
                                word_bytes=word_bytes, max_evals=max_evals,
                                d_w_cap=ny, batch=batch, n_steps=n_steps)
        n_meas, source = 0, "model"
    registry.put(spec, grid_shape, res.plan, res.score, source=source,
                 evals=len(res.evaluated), word_bytes=word_bytes,
                 devices_x=devices_x, batch=batch)
    return {"stencil": spec.name, "source": source, "plan": res.plan,
            "score": res.score, "measurements": n_meas,
            "evals": len(res.evaluated), "evaluated": res.evaluated,
            "seconds": time.perf_counter() - t0}


def plan_name(plan) -> str:
    """Short form of a plan: ``dw8.nf2.tg1.fused``."""
    return (f"dw{plan.d_w}.nf{plan.n_f}.tg{plan.tg_x}."
            f"{'fused' if plan.fused else 'row'}")


def main(argv=None) -> list[dict]:
    """CLI entry point; returns the per-stencil reports (tested directly)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tune",
        description="Measured MWD auto-tuning with a persistent registry")
    ap.add_argument("--stencil", action="append",
                    help="stencil(s) to tune: paper op, registered custom "
                         "op, or module.path:ATTR (default: all four)")
    ap.add_argument("--op-module", default=None,
                    help="import this module first (it registers custom "
                         "StencilOps via repro_torch.core.ir.register)")
    ap.add_argument("--grid", type=str, default=None,
                    help="Z,Y,X grid (default: per-stencil sanity scale)")
    ap.add_argument("--dtype", type=str, default=None,
                    help="stream dtype to tune at (f32/bf16/fp16); the "
                         "winner persists under the dtype's w<word> key")
    ap.add_argument("--word-bytes", type=int, default=None,
                    help="registry word-size key segment (default: derived "
                         "from --dtype, 4 when neither given)")
    ap.add_argument("--devices-x", type=int, default=1)
    ap.add_argument("--batch", type=int, default=1,
                    help="tune the batched serving launch: measure ONE "
                         "ops.mwd_batched call advancing B problems and "
                         "persist under the b<B> registry key")
    ap.add_argument("--registry", type=str, default=None,
                    help=f"registry path (default ${reg.ENV_VAR} or "
                         f"{reg.DEFAULT_PATH})")
    ap.add_argument("--model-only", action="store_true",
                    help="score with the model, no wall-clock measurement")
    ap.add_argument("--max-evals", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3,
                    help="timed calls per measured candidate (median)")
    ap.add_argument("--steps", type=int, default=4,
                    help="time steps each measured call advances")
    ap.add_argument("--force", action="store_true",
                    help="re-tune even on a registry hit")
    ap.add_argument("--spec", type=str, default=None,
                    help="device spec name or spec-file path the models "
                         "price against (default: $REPRO_TORCH_DEVICE_SPEC "
                         f"or {devspecs.DEFAULT_SPEC_NAME})")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--expect-cached", action="store_true",
                    help="fail (exit 3) if any stencil performed a "
                         "measurement: proves a warmed registry resolves "
                         "with zero re-measurement")
    args = ap.parse_args(argv)

    if args.spec:
        devspecs.set_default_spec(args.spec)
    if args.op_module:
        import importlib
        importlib.import_module(args.op_module)
    registry = (reg.PlanRegistry(args.registry) if args.registry
                else reg.default_registry())
    specs = [ir.resolve_op(n) for n in (args.stencil or st.SPECS)]
    grid = (tuple(int(x) for x in args.grid.split(",")) if args.grid
            else None)

    print(f"# registry={registry.path} "
          f"spec={devspecs.current_spec().name} "
          f"fingerprint={devspecs.fingerprint()} device={args.device}")
    print("stencil,source,plan,score_GLUPs,measurements,evals,seconds")
    reports = []
    for spec in specs:
        g = grid or reg.default_grid(spec)
        r = tune_one(spec, g, registry, word_bytes=args.word_bytes,
                     devices_x=args.devices_x, measured=not args.model_only,
                     max_evals=args.max_evals, reps=args.reps,
                     n_steps=args.steps, force=args.force, batch=args.batch,
                     dtype=args.dtype, device=args.device)
        print(f"{r['stencil']},{r['source']},{plan_name(r['plan'])},"
              f"{r['score']:.3f},{r['measurements']},{r['evals']},"
              f"{r['seconds']:.1f}")
        reports.append(r)
    if args.expect_cached and any(r["measurements"] for r in reports):
        import sys
        hot = [r["stencil"] for r in reports if r["measurements"]]
        print(f"--expect-cached: measurements performed for {hot} "
              f"(registry miss or stale fingerprint)", file=sys.stderr)
        raise SystemExit(3)
    return reports


if __name__ == "__main__":
    main()
