"""The control of the check: the plain reference in the nearest precision
below the configuration's, judged as the program's answers are.

    python3 girih_bench/control.py --workload NAME --seeds 1 2 3

For each seed the cell's inputs are drawn as a run draws them, the
reference advances every judged grid in the configuration's dtype and
again in the control's (float32 for float64, every input rounded to it),
and the control's answer is read by `check.state_gap` against the first.
Beside it, the reference with its sums taken in the opposite order
(``reordered``) reads what a sound program that rounds differently would.
Prints one JSON line a seed, with the cell's limit beside the readings: a
sound limit lies below every control reading and above the reordered
ones. Runs on the card, at the cell's own sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONTROL_DTYPE = {"float64": "float32"}


def reading(name: str, seed: int) -> dict:
    """The control's largest gap over a seed's judged grids."""
    import torch
    from girih_bench import check, harness, inputs
    from girih_bench.reference import stencils as ref
    cell = harness.make_cell(name, seed, "cuda", harness.manifest())
    low = inputs.DTYPES[CONTROL_DTYPE[cell.config["dtype"]]]
    gap = reordered = 0.0
    t0 = time.perf_counter()
    for p in harness.runner(cell.traffic).problems(cell):
        args = (ref.name_of(cell.config), p.state, p.arrays, p.scalars,
                cell.traffic["steps"])
        want = ref.advance(*args)
        got = ref.advance(*args, dtype=low)
        gap = max(gap, check.state_gap(got, want))
        del got
        other = ref.advance(*args, reverse=True)
        reordered = max(reordered, check.state_gap(other, want))
        del want, other
    torch.cuda.synchronize()
    return {"workload": name, "seed": seed, "control": str(low),
            "gap": gap, "reordered": reordered,
            "limit": check.limits(name)["gap"],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    """Print the control's reading of each seed."""
    ap = argparse.ArgumentParser(prog="girih_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(reading(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
