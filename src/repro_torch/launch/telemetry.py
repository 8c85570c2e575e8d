"""Pluggable live telemetry for the serving tier.

The port's copy of `repro.launch.telemetry`.

The serving loop (`repro_torch.launch.serve`) narrates itself through a
`Telemetry` sink: one `emit(event, **fields)` call per queue decision —
``admit`` / ``reject`` / ``launch`` / ``summary`` — with flat JSON-able
fields (bucket key, batch size, request ids, queue depths, padding waste,
plan-cache source, waits).  Sinks are deliberately tiny (in the spirit of
HomebrewNLP's wandblog shim): the default is a no-op, ``stdout`` prints one
compact line per event, and ``jsonl:<path>`` appends machine-readable JSON
lines a dashboard (or the soak-report summarizer) can tail.

`Aggregator` is the in-process rollup every server keeps regardless of
sink: per-bucket throughput/served/batches, padding waste, plan-cache hit
rate and the counters of `core.trace` over the server's run, rejection
count, and latency percentiles over every request served.
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np

from repro_torch.core import trace

# the counters of plan resolution by source (`kernels.ops.count_plan`)
PLAN_SOURCES = ("plan.registry", "plan.translated", "plan.model",
                "plan.explicit")


class Telemetry:
    """No-op telemetry sink (base class: subclass and override `emit`)."""

    def emit(self, event: str, **fields) -> None:
        """Record one serving event; base class drops it."""

    def close(self) -> None:
        """Flush/release the sink (no-op by default)."""


class StdoutTelemetry(Telemetry):
    """One compact ``serve[event] k=v ...`` line per event on stdout."""

    def emit(self, event: str, **fields) -> None:
        """Print the event as a single key=value line."""
        kv = " ".join(f"{k}={_short(v)}" for k, v in fields.items())
        print(f"serve[{event}] {kv}")


class JsonlTelemetry(Telemetry):
    """Append one JSON object per event to a file (JSON-lines)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def emit(self, event: str, **fields) -> None:
        """Append ``{"event": ..., "t_s": ..., **fields}`` as one JSON line."""
        rec = {"event": event, "t_s": time.time(), **fields}
        self._f.write(json.dumps(rec, default=_jsonable) + "\n")
        self._f.flush()

    def close(self) -> None:
        """Close the underlying file."""
        self._f.close()


def _short(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return v


def _jsonable(v):
    if isinstance(v, tuple):
        return list(v)
    return str(v)


def make_telemetry(spec) -> Telemetry:
    """CLI spec -> sink: None/"" -> no-op, ``stdout``, or ``jsonl:<path>``.

    A `Telemetry` instance passes through unchanged, so programmatic callers
    can hand the server a custom sink.
    """
    if isinstance(spec, Telemetry):
        return spec
    if not spec:
        return Telemetry()
    if spec == "stdout":
        return StdoutTelemetry()
    if str(spec).startswith("jsonl:"):
        return JsonlTelemetry(str(spec)[len("jsonl:"):])
    raise ValueError(f"unknown telemetry spec {spec!r}; "
                     "use 'stdout' or 'jsonl:<path>'")


def percentiles_ms(latencies_s) -> tuple[float, float, float]:
    """p50, p95 and p99 of `latencies_s` in ms (numpy's linear
    interpolation; zeros when there are none)."""
    if not len(latencies_s):
        return 0.0, 0.0, 0.0
    p50, p95, p99 = np.percentile(latencies_s, [50, 95, 99])
    return float(p50) * 1e3, float(p95) * 1e3, float(p99) * 1e3


class Aggregator:
    """In-process rollup of the serving loop's live metrics.

    Tracks per-bucket served/batches/launch-time, padding waste,
    rejections, every served request's latency, and the counters of
    `core.trace` from the aggregator's creation on: the plan-cache hit rate
    is the share of plan resolutions counted under ``plan.registry``.
    `snapshot()` returns the flat dict the server logs as its ``summary``
    event and embeds in its report.
    """

    def __init__(self):
        self.latencies: list[float] = []
        self.buckets: dict = collections.defaultdict(
            lambda: {"served": 0, "batches": 0, "launch_s": 0.0,
                     "padded_cells": 0, "real_cells": 0})
        self.rejected = 0
        self.deadline_misses = 0
        self._counts0 = trace.counts()

    def on_reject(self) -> None:
        """Count one admission-control rejection."""
        self.rejected += 1

    def on_launch(self, key, size: int, launch_s: float,
                  padded_cells: int, real_cells: int) -> None:
        """Fold one completed batch launch into the per-bucket stats."""
        b = self.buckets[key]
        b["served"] += size
        b["batches"] += 1
        b["launch_s"] += launch_s
        b["padded_cells"] += padded_cells
        b["real_cells"] += real_cells

    def on_done(self, latency_s: float, deadline_missed: bool) -> None:
        """Record one served request's latency (and a possible SLO miss)."""
        self.latencies.append(float(latency_s))
        if deadline_missed:
            self.deadline_misses += 1

    def counters(self) -> dict:
        """``{name: [count, seconds]}`` of every `core.trace` counter that
        moved since the aggregator was made."""
        out = {}
        for name, (n, sec) in trace.counts().items():
            n0, sec0 = self._counts0.get(name, (0, 0.0))
            if n != n0:
                out[name] = [n - n0, sec - sec0]
        return out

    @property
    def plan_cache_hit_rate(self) -> float:
        """Fraction of plan resolutions served by the persistent registry."""
        moved = self.counters()
        plans = [moved.get(name, [0])[0] for name in PLAN_SOURCES]
        total = sum(plans)
        return plans[0] / total if total else 0.0

    def snapshot(self) -> dict:
        """Flat summary dict: totals, waste, hit rate, latency percentiles,
        counters."""
        served = sum(b["served"] for b in self.buckets.values())
        batches = sum(b["batches"] for b in self.buckets.values())
        padded = sum(b["padded_cells"] for b in self.buckets.values())
        real = sum(b["real_cells"] for b in self.buckets.values())
        p50, p95, p99 = percentiles_ms(self.latencies)
        return {
            "served": served, "batches": batches,
            "rejected": self.rejected,
            "deadline_misses": self.deadline_misses,
            "padding_waste": (padded - real) / real if real else 0.0,
            "plan_cache_hit_rate": self.plan_cache_hit_rate,
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "buckets": {str(k): dict(v) for k, v in self.buckets.items()},
            "counters": self.counters(),
        }
