"""Gate for the reduced-precision leg of the port's sweep.

The port of `benchmarks/precision_gate.py`. Two gates, both computed from
a sweep results file (`repro_torch.launch.sweep`, its bf16 leg):

1. **Traffic**: K1's B/LUP at the bf16 fused point must be at most
   ``--max-ratio`` (default 0.6) times the f32 point's on the same
   (stencil, grid). Streams are half-width, so a healthy kernel sits at
   0.5x exactly; anything above the gate means some stream stopped
   honouring the reduced word.

2. **Model residual**: the ECM calibration (`models.fit_ecm`) refitted
   over every measured point, reduced-precision points included, must keep
   its max |calibrated - measured| / measured under ``--max-residual``.
   The word-size-aware model predicting the halved B/LUP is what makes the
   bf16 points fit the same line as the f32 points; a residual blow-up
   means the model and the kernel disagree about what the reduced word
   changed.

  python -m repro_torch.launch.precision_gate \\
      --results src/repro_torch/results/sweep.json

Exit code 0 = both gates pass; 1 = violation (printed).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import models
from repro_torch.launch.sweep import DEFAULT_RESULTS

DEFAULT_STENCIL = "7pt-var"
DEFAULT_MAX_RATIO = 0.6
# the reference's ceiling: the gate exists to catch the order-of-magnitude
# blow-up of a model/kernel word-size disagreement (bf16 bytes counted at
# w4 doubles the predicted traffic term), not timing noise
DEFAULT_MAX_RESIDUAL = 6.0


def load_points(path: str) -> list[dict]:
    with open(path) as f:
        raw = json.load(f)
    return list(raw.get("points", {}).values())


def traffic_gate(points: list[dict], stencil: str, dtype: str,
                 max_ratio: float) -> list[str]:
    """B/LUP ratio violations (empty list = pass). Missing points violate."""
    def select(dt):
        return {tuple(p["grid"]): p for p in points
                if p["stencil"] == stencil and p.get("dtype", "f32") == dt
                and p["mode"] == "fused" and p["batch"] == 1
                and not p.get("distributed")}

    reduced, base = select(dtype), select("f32")
    pairs = [(g, reduced[g], base[g]) for g in sorted(reduced) if g in base]
    if not pairs:
        return [f"no ({stencil}, {dtype}) + f32 point pair in the results — "
                "did the sweep lose its reduced-precision leg?"]
    out = []
    for grid, rp, fp in pairs:
        ratio = rp["traffic"]["b_per_lup"] / fp["traffic"]["b_per_lup"]
        line = (f"{stencil} {'x'.join(map(str, grid))}: {dtype} B/LUP "
                f"{rp['traffic']['b_per_lup']:.2f} = {ratio:.3f}x f32 "
                f"(gate {max_ratio}x)")
        print("  " + line)
        if ratio > max_ratio:
            out.append(line)
    return out


def residual_gate(points: list[dict], max_residual: float) -> list[str]:
    """ECM-fit residual violations (empty list = pass)."""
    fit_pts = [{"key": p["key"], "flops": p["flops"],
                "hbm_bytes": p["traffic"]["hbm_bytes"],
                "measured_s": p["measured"]["t_s"]}
               for p in points if not p.get("distributed")]
    if len(fit_pts) < 3:
        return [f"only {len(fit_pts)} measured points — cannot fit the ECM"]
    rep = models.model_residuals(fit_pts)
    worst = max(rep["per_point"], key=lambda e: abs(e["rel_err"]))
    print(f"  ECM fit over {rep['n']} points: max |residual| "
          f"{rep['max_abs_rel_err']:.0%} (gate {max_residual:.0%}), "
          f"worst at {worst['key']}")
    if rep["max_abs_rel_err"] > max_residual:
        return [f"max model residual {rep['max_abs_rel_err']:.0%} exceeds "
                f"the {max_residual:.0%} gate (worst point {worst['key']}: "
                f"measured {worst['measured_s']:.4f}s vs calibrated "
                f"{worst['calibrated_s']:.4f}s)"]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.precision_gate",
        description="Gate the sweep's reduced-precision leg")
    ap.add_argument("--results", default=DEFAULT_RESULTS)
    ap.add_argument("--stencil", default=DEFAULT_STENCIL)
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--max-ratio", type=float, default=DEFAULT_MAX_RATIO,
                    help="reduced-vs-f32 B/LUP ratio ceiling")
    ap.add_argument("--max-residual", type=float,
                    default=DEFAULT_MAX_RESIDUAL,
                    help="ECM calibrated-vs-measured |residual| ceiling")
    args = ap.parse_args(argv)

    points = load_points(args.results)
    print(f"precision gate: {len(points)} points from {args.results}")
    violations = traffic_gate(points, args.stencil, args.dtype,
                              args.max_ratio)
    violations += residual_gate(points, args.max_residual)
    if violations:
        for v in violations:
            print(f"GATE VIOLATION: {v}", file=sys.stderr)
        return 1
    print("precision gate: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
