"""Run one cell of the benchmark once and print its result line.

    python3 girih_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with a CUDA card. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced runs)
and ``check`` (each compared number beside its limit), also printed as the
last lines of standard error. Exits non-zero and prints no result without
a card, with fewer cards than the cell asks for, outside a checkout of the
repository, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    """One run of one cell; the exit code."""
    ap = argparse.ArgumentParser(prog="girih_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    import torch
    from girih_bench import check, harness
    bench = harness.manifest()
    chips = harness.workload(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    plans = tempfile.mkdtemp(prefix="girih_bench_plans_")
    os.environ["REPRO_TORCH_PLAN_REGISTRY"] = os.path.join(plans, "plans.json")
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), device="cuda",
                               t_start=T_START, bench=bench)
    finally:
        shutil.rmtree(plans, ignore_errors=True)
    if "error" in out:
        print(out["error"], file=sys.stderr)
        return 3
    print(f"card {card_line()}", file=sys.stderr)
    check.print_check(out["check"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
