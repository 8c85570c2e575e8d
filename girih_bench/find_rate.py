"""Find a serving cell's knee: the highest offered rate at which the
server's backlog does not grow.

    python3 girih_bench/find_rate.py --workload NAME --seed N

One process sets the cell up once, then (1) offers far more than the
server can take (`PROBE_RATE` for `PROBE_S`) and reads its capacity, the
requests it served over the time it took; (2) offers rising `FRACTIONS` of
that capacity, all below it (at or above it the queue grows by
construction), a window of `WINDOW_S` each, until one is not sustained. A
rate is sustained when nothing was rejected and the mean latency of the
requests due in the window's last quarter exceeds that of its first
quarter by at most one mean launch: the backlog grew by less than one
batch. The knee is the last sustained rate. Prints one JSON line a window
and, last, the knee and the cell's rate at four fifths of it; the cell's
traffic file then takes that rate as a number.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PROBE_RATE = 300.0          # requests/s, far above either cell's capacity
PROBE_S = 1.5
WINDOW_S = 6.0
FRACTIONS = (0.5, 0.6, 0.7, 0.8, 0.85, 0.9, 0.95)


def summary(rec: dict, seconds: float) -> dict:
    """What one window says of the backlog."""
    lat, due = rec["latency_s"], rec["due_s"]
    first = lat[due < seconds / 4]
    last = lat[due >= 3 * seconds / 4]
    launch = np.mean([r["launch_s"] for r in rec["launches"]])
    sustained = bool(rec["failed"] == 0 and len(first) and len(last)
                     and last.mean() <= first.mean() + launch)
    return {"rate_per_s": rec["rate_per_s"], "requests": rec["attempted"],
            "rejected": rec["failed"], "wall_s": rec["window_s"],
            "served_per_s": (rec["attempted"] - rec["failed"])
            / rec["window_s"],
            "p50_ms": rec["end_to_end"]["serve_p50_ms"],
            "p95_ms": rec["end_to_end"]["serve_p95_ms"],
            "first_quarter_ms": 1e3 * float(first.mean()) if len(first)
            else None,
            "last_quarter_ms": 1e3 * float(last.mean()) if len(last)
            else None,
            "launch_ms": 1e3 * float(launch),
            "batch_mean": float(np.mean([r["size"]
                                         for r in rec["launches"]])),
            "sustained": sustained}


def main(argv=None) -> int:
    """Probe the capacity, sweep the rates, print the knee."""
    ap = argparse.ArgumentParser(prog="girih_bench/find_rate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from girih_bench import harness
    plans = tempfile.mkdtemp(prefix="girih_bench_plans_")
    os.environ["REPRO_TORCH_PLAN_REGISTRY"] = os.path.join(plans, "plans.json")
    try:
        cell = harness.make_cell(args.workload, args.seed, "cuda",
                                 harness.manifest())
        drv = harness.runner(cell.traffic).Runner(cell)
        probe = drv.window(PROBE_S, rate=PROBE_RATE)
        capacity = (probe["attempted"] - probe["failed"]) / probe["window_s"]
        print(json.dumps({"probe": summary(probe, PROBE_S),
                          "capacity_per_s": capacity}), flush=True)
        knee = None
        for f in FRACTIONS:
            s = summary(drv.window(WINDOW_S, rate=round(f * capacity, 1)),
                        WINDOW_S)
            print(json.dumps(s), flush=True)
            if not s["sustained"]:
                break
            knee = s["rate_per_s"]
        print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                          "rate_per_s": (round(0.8 * knee, 1)
                                         if knee else None)}), flush=True)
    finally:
        shutil.rmtree(plans, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
