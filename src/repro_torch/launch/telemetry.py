"""Pluggable live telemetry for the serving tier.

The port's copy of `repro.launch.telemetry` (pure Python, unchanged).

The serving loop (`repro_torch.launch.serve`) narrates itself through a
`Telemetry` sink: one `emit(event, **fields)` call per queue decision —
``admit`` / ``reject`` / ``launch`` / ``summary`` — with flat JSON-able
fields (bucket key, batch size, queue depths, padding waste, plan-cache
source, latency).  Sinks are deliberately tiny (in the spirit of
HomebrewNLP's wandblog shim): the default is a no-op, ``stdout`` prints one
compact line per event, and ``jsonl:<path>`` appends machine-readable JSON
lines a dashboard (or the soak-report summarizer) can tail.

`Aggregator` is the in-process rollup every server keeps regardless of
sink: per-bucket throughput/served/batches, padding waste, plan-cache hit
rate, rejection count, and rolling latency percentiles (`Rolling`).
"""

from __future__ import annotations

import collections
import json
import time


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


class TeeTelemetry(Telemetry):
    """Fan one event stream out to several sinks."""

    def __init__(self, *sinks: Telemetry):
        self.sinks = sinks

    def emit(self, event: str, **fields) -> None:
        """Forward the event to every sink."""
        for s in self.sinks:
            s.emit(event, **fields)

    def close(self) -> None:
        """Close every sink."""
        for s in self.sinks:
            s.close()


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


class Rolling:
    """Rolling sample window with percentile readout (latency SLO tracking)."""

    def __init__(self, maxlen: int = 1024):
        self._win = collections.deque(maxlen=maxlen)

    def add(self, v: float) -> None:
        """Append one sample (oldest drops past the window length)."""
        self._win.append(float(v))

    def __len__(self) -> int:
        return len(self._win)

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the window; 0.0 when empty."""
        if not self._win:
            return 0.0
        xs = sorted(self._win)
        i = min(len(xs) - 1, max(0, round(q / 100.0 * (len(xs) - 1))))
        return xs[i]

    def summary(self) -> dict:
        """``{n, p50, p95, p99, mean}`` of the current window."""
        n = len(self._win)
        return {"n": n,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "mean": (sum(self._win) / n) if n else 0.0}


class Aggregator:
    """In-process rollup of the serving loop's live metrics.

    Tracks per-bucket served/batches/launch-time, padding waste, plan-cache
    hits (``registry:*`` sources), rejections, and a rolling latency window.
    `snapshot()` returns the flat dict the server logs as its ``summary``
    event and embeds in its report.
    """

    def __init__(self, window: int = 1024):
        self.latency = Rolling(window)
        self.buckets: dict = collections.defaultdict(
            lambda: {"served": 0, "batches": 0, "launch_s": 0.0,
                     "padded_cells": 0, "real_cells": 0})
        self.rejected = 0
        self.deadline_misses = 0
        self._plan_hits = 0
        self._plan_lookups = 0

    def on_reject(self) -> None:
        """Count one admission-control rejection."""
        self.rejected += 1

    def on_launch(self, key, size: int, launch_s: float,
                  padded_cells: int, real_cells: int,
                  plan_source: str) -> None:
        """Fold one completed batch launch into the per-bucket stats."""
        b = self.buckets[key]
        b["served"] += size
        b["batches"] += 1
        b["launch_s"] += launch_s
        b["padded_cells"] += padded_cells
        b["real_cells"] += real_cells
        self._plan_lookups += 1
        if str(plan_source).startswith("registry:"):
            self._plan_hits += 1

    def on_done(self, latency_s: float, deadline_missed: bool) -> None:
        """Record one served request's latency (and a possible SLO miss)."""
        self.latency.add(latency_s)
        if deadline_missed:
            self.deadline_misses += 1

    @property
    def plan_cache_hit_rate(self) -> float:
        """Fraction of launches whose plan came from the persistent registry."""
        return (self._plan_hits / self._plan_lookups
                if self._plan_lookups else 0.0)

    def snapshot(self) -> dict:
        """Flat summary dict: totals, waste, hit rate, latency percentiles."""
        served = sum(b["served"] for b in self.buckets.values())
        batches = sum(b["batches"] for b in self.buckets.values())
        padded = sum(b["padded_cells"] for b in self.buckets.values())
        real = sum(b["real_cells"] for b in self.buckets.values())
        lat = self.latency.summary()
        return {
            "served": served, "batches": batches,
            "rejected": self.rejected,
            "deadline_misses": self.deadline_misses,
            "padding_waste": (padded - real) / real if real else 0.0,
            "plan_cache_hit_rate": self.plan_cache_hit_rate,
            "p50_ms": lat["p50"] * 1e3, "p95_ms": lat["p95"] * 1e3,
            "p99_ms": lat["p99"] * 1e3,
            "buckets": {str(k): dict(v) for k, v in self.buckets.items()},
        }
