"""One run of one cell: find its pieces by name, set up, measure, check.

`BENCHMARK.json` names each cell's configuration and traffic; the harness
finds ``configs/<config>.json``, ``traffic/<traffic>.json`` (whose
``"runner"`` names a module of ``runners/``), ``limits/<cell>.json`` and,
for a traced run, ``metrics/<metric>.py`` of each per-layer metric that
lists the cell (or lists none). Nothing here names a cell, a configuration
or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from girih_bench import check

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """What a runner is built from: the cell's name, its configuration and
    traffic parameters, the seed and the device."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    device: torch.device

    def sync(self) -> None:
        """Wait for the device (nothing to wait for on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def manifest(path: Path = MANIFEST) -> dict:
    """`BENCHMARK.json`, parsed."""
    return json.loads(path.read_text())


def workload(name: str, bench: dict) -> dict:
    """The manifest's entry of cell `name`; exits where there is none."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; known: "
                     f"{[w['name'] for w in bench['workloads']]}")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    """``<kind>/<name>.json`` of the benchmark's folder."""
    return json.loads((root / kind / f"{name}.json").read_text())


def runner(traffic: dict):
    """The runner module a traffic file names."""
    return importlib.import_module(f"girih_bench.runners.{traffic['runner']}")


def reader(metric: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"girih_bench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(kind: str, cell: str, bench: dict) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def make_cell(name: str, seed: int, device, bench: dict,
              overrides: dict | None = None, root: Path = HERE) -> Cell:
    """The `Cell` of workload `name`; `overrides` replaces configuration
    and traffic keys (``{"config": {...}, "traffic": {...}}``)."""
    w = workload(name, bench)
    config = load_json("configs", w["config"], root)
    traffic = load_json("traffic", w["traffic"], root)
    for part, d in ((config, "config"), (traffic, "traffic")):
        part.update((overrides or {}).get(d, {}))
    return Cell(name, config, traffic, seed, torch.device(device))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             bench: dict | None = None, overrides: dict | None = None
             ) -> dict:
    """One run: set-up, the window, the reference check. Returns the
    result's keys (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown`` when traced, ``check`` last) and, under
    ``error``, why no result may be printed."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or manifest()
    cell = make_cell(name, seed, device, bench, overrides)
    limit = check.limits(name)
    drv = runner(cell.traffic).Runner(cell)
    setup_s = time.perf_counter() - t_start
    if trace:
        from girih_bench import trace as tracing
        rec, traced = tracing.profiled(lambda: drv.window(seconds))
        rec["trace"] = traced
    else:
        rec = drv.window(seconds)
    on_card = cell.device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(cell.device) if on_card
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(cell.device)
                                 if on_card else 0)}
    bad = forbidden_modules()
    if bad:
        return {"error": f"modules loaded in the run's process: {bad}"}
    numbers = drv.check()
    correct, shown = check.verdict(numbers, limit)
    if trace:
        metrics = {}
        for m in metrics_of("per_layer", name, bench):
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    else:
        values = dict(rec["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of("end_to_end", name, bench)}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": rec["trace"]["top_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["check"] = shown
    return out
