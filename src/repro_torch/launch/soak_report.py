"""Render the soak report and gate on its SLOs.

The port of ``benchmarks/soak_report.py``, with the same flags, lines and
exit codes. Reads the JSON report of ``python -m repro_torch.launch.soak``
and checks it against explicit thresholds:

  python -m repro_torch.launch.soak_report .repro_torch_cache/soak.json \\
      --max-p99-ms 2500 --max-dropped 0 --min-throughput-ratio 1.0

Prints one line per metric and a final ``SOAK GATE: PASS``/``FAIL``; exits
1 on any breach.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    """CLI of the soak-report gate (split out so tests can parse args)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.soak_report")
    ap.add_argument("report", help="JSON report from 'repro_torch.launch.soak'")
    ap.add_argument("--max-p99-ms", type=float, required=True,
                    help="fail when served p99 latency exceeds this")
    ap.add_argument("--max-dropped", type=int, default=0,
                    help="fail when more requests were dropped (default 0)")
    ap.add_argument("--min-throughput-ratio", type=float, default=0.0,
                    help="fail when batched/sequential throughput ratio "
                         "falls below this (default: not gated)")
    return ap


def verdict(report: dict, *, max_p99_ms: float, max_dropped: int = 0,
            min_throughput_ratio: float = 0.0) -> list[str]:
    """Evaluate one soak report against the thresholds.

    Returns the human-readable failure reasons (empty: the gate passes).
    """
    fails = []
    p99 = report.get("p99_ms")
    if p99 is None:
        fails.append("report has no p99_ms (soak did not complete)")
    elif p99 > max_p99_ms:
        fails.append(f"p99 {p99:.1f}ms exceeds the {max_p99_ms:.1f}ms gate")
    dropped = report.get("dropped", 0)
    if dropped > max_dropped:
        fails.append(f"{dropped} dropped requests exceed the "
                     f"{max_dropped} allowed")
    if not report.get("bitwise_ok", False):
        fails.append("responses were NOT bitwise-equal to sequential runs")
    ratio = report.get("throughput_ratio", 0.0)
    if ratio < min_throughput_ratio:
        fails.append(f"throughput ratio {ratio:.2f}x below the "
                     f"{min_throughput_ratio:.2f}x gate")
    return fails


def main(argv=None) -> int:
    """Print the report summary and the gate verdict; return the exit code."""
    args = build_parser().parse_args(argv)
    with open(args.report) as f:
        report = json.load(f)

    print(f"soak report: {args.report}")
    print(f"  op={report.get('op')} plan={report.get('plan')} "
          f"seed={report.get('seed')}")
    print(f"  requests={report.get('n_requests')} "
          f"served={report.get('served')} dropped={report.get('dropped')} "
          f"deadline_misses={report.get('deadline_misses')}")
    print(f"  classes={report.get('classes')} "
          f"batches={len(report.get('batch_sizes', []))} "
          f"sizes={report.get('batch_sizes')} "
          f"padding_waste={report.get('padding_waste', 0.0):.3f}")
    print(f"  p50={report.get('p50_ms', 0.0):.1f}ms "
          f"p95={report.get('p95_ms', 0.0):.1f}ms "
          f"p99={report.get('p99_ms', 0.0):.1f}ms "
          f"(gate {args.max_p99_ms:.1f}ms)")
    print(f"  bitwise_ok={report.get('bitwise_ok')} "
          f"throughput_ratio={report.get('throughput_ratio', 0.0):.2f}x")

    fails = verdict(report, max_p99_ms=args.max_p99_ms,
                    max_dropped=args.max_dropped,
                    min_throughput_ratio=args.min_throughput_ratio)
    for reason in fails:
        print(f"  FAIL: {reason}")
    print(f"SOAK GATE: {'FAIL' if fails else 'PASS'}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
