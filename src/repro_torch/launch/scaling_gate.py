"""Gate: overlapped super-steps must not be slower than synchronous ones.

The port of `benchmarks/scaling_gate.py`. Reads the scaling lattice that
``python -m repro_torch.launch.sweep --scaling`` writes and pairs every
overlapped leg with the synchronous leg of the same (stencil, grid,
shards, regime). Both legs sweep the same cells and exchange the same
bytes; they differ only in whether the interior advance waits for the
halo exchange, so the pair ratio isolates the scheduling win of the
paper's Sec. 4.2 overlap.

The gate holds the largest-mesh rungs: the geometric mean of their
overlapped/synchronous throughput ratios must reach ``--min-ratio``
(default 1.0), and every one of those pairs must clear
``--min-pair-ratio`` (default 0.9, a noise floor).

Its premise is an exchange on a link of its own. Where every shard sits
on one card, the halo copies share the card's memory system with the
compute, so the ratio there reads the cost of the overlap machinery on one
card, not the win across cards.

  python -m repro_torch.launch.scaling_gate \\
      --results src/repro_torch/results/sweep-scaling.json
"""

from __future__ import annotations

import argparse
import json
import math

from repro_torch.launch.sweep import SCALING_RESULTS


def load_points(path: str) -> dict:
    with open(path) as f:
        raw = json.load(f)
    return raw.get("points", {})


def scaling_pairs(points: dict) -> list[dict]:
    """Overlap/sync throughput pairs keyed by (stencil, grid, n, regime).

    The ratio prefers the overlapped point's interleaved paired sync time
    (``measured["paired_sync_t_s"]``): both schedules timed in one
    session, so drift between separately measured points cannot fake a
    win or a loss. Standalone sync points supply the table's absolute sync
    throughput and the ratio where no paired time was recorded.
    """
    legs: dict[tuple, dict] = {}
    for p in points.values():
        m = p.get("measured", {})
        if not p.get("distributed") or not m.get("scaling"):
            continue
        ident = (p["stencil"], tuple(p["grid"]), m["n_devices"],
                 m["scaling"])
        legs.setdefault(ident, {})["overlap" if m.get("overlap")
                                   else "sync"] = p
    pairs = []
    for (stencil, grid, n, regime), sides in sorted(legs.items()):
        if "overlap" not in sides or "sync" not in sides:
            continue
        om = sides["overlap"]["measured"]
        ovl = om["glups"]
        syn = sides["sync"]["measured"]["glups"]
        if om.get("paired_sync_t_s"):
            ratio = om["paired_sync_t_s"] / om["t_s"]
        else:
            ratio = ovl / syn
        pairs.append({"stencil": stencil, "grid": grid, "n_devices": n,
                      "scaling": regime, "overlap_glups": ovl,
                      "sync_glups": syn, "ratio": ratio})
    return pairs


def verdict(pairs: list[dict], min_ratio: float = 1.0,
            min_pair_ratio: float = 0.9) -> dict:
    """The gate over the largest-mesh pairs: ``ok``, the geometric-mean
    ratio, the worst pair and the reason it failed (if it did)."""
    n_max = max(p["n_devices"] for p in pairs)
    gated = [p for p in pairs if p["n_devices"] == n_max]
    gmean = math.exp(sum(math.log(p["ratio"]) for p in gated) / len(gated))
    worst = min(gated, key=lambda p: p["ratio"])
    reason = None
    if gmean < min_ratio:
        reason = (f"overlapped geomean {gmean:.3f} < {min_ratio}: the "
                  "overlapped schedule lost throughput against the "
                  "synchronous one")
    elif worst["ratio"] < min_pair_ratio:
        reason = (f"pair {worst['stencil']} {worst['scaling']} ratio "
                  f"{worst['ratio']:.3f} < {min_pair_ratio}")
    return {"ok": reason is None, "n_devices": n_max, "pairs": len(gated),
            "geomean": gmean, "worst": worst["ratio"], "reason": reason}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.scaling_gate",
        description="Gate overlapped >= synchronous steady-state throughput "
                    "on the scaling sweep's largest mesh")
    ap.add_argument("--results", default=SCALING_RESULTS,
                    help="sweep-scaling.json written by `repro_torch.launch."
                         "sweep --scaling` (default: the committed one)")
    ap.add_argument("--min-ratio", type=float, default=1.0,
                    help="geometric-mean overlapped/sync throughput ratio "
                         "the max-device pairs must reach (default 1.0)")
    ap.add_argument("--min-pair-ratio", type=float, default=0.9,
                    help="floor for every individual max-device pair "
                         "(default 0.9)")
    args = ap.parse_args(argv)

    pairs = scaling_pairs(load_points(args.results))
    if not pairs:
        print(f"scaling gate: no overlap/sync pairs in {args.results}")
        return 1
    v = verdict(pairs, args.min_ratio, args.min_pair_ratio)
    for p in pairs:
        mark = "*" if p["n_devices"] == v["n_devices"] else " "
        print(f"{mark} {p['stencil']:12s} "
              f"{'x'.join(map(str, p['grid'])):>12s} d{p['n_devices']} "
              f"{p['scaling']:6s} overlap {p['overlap_glups']:.5f} "
              f"sync {p['sync_glups']:.5f} GLUP/s ratio {p['ratio']:.3f}")
    print(f"gate: {v['pairs']} pairs at d{v['n_devices']}, geomean ratio "
          f"{v['geomean']:.3f} (need >= {args.min_ratio}), worst "
          f"{v['worst']:.3f} (need >= {args.min_pair_ratio})")
    if not v["ok"]:
        print(f"FAIL: {v['reason']}")
        return 1
    print("scaling gate OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
