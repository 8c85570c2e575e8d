"""The harness on the CPU: the manifest, the yardstick, the traffic, the
readers, the traced record and the modules a run loads."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from girih_bench import check, harness, roofline
from girih_bench.reference import stencils as ref
from girih_bench.runners import serve_open

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_SERVE = {"traffic": {"axes": [10, 12, 14, 16], "tenants": 4,
                          "rate_per_s": 8.0, "segment_s": 0.25,
                          "sample": 4, "warm_s": 0.2}}


def test_manifest_names_every_piece():
    bench = harness.manifest()
    assert bench["paths"] == ["girih_bench"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and Path(ROOT, c["file"]).is_file()
        assert json.loads(Path(ROOT, c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert len(w["why"]) <= 200 and w["chips"] == 1
        traffic = harness.load_json("traffic", w["traffic"])
        harness.runner(traffic)
        assert "gap" in harness.check.limits(w["name"])
        e2e = {m["name"] for m in harness.metrics_of("end_to_end", w["name"],
                                                     bench)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of("per_layer", w["name"], bench)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        harness.reader(m["name"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_roofline_bounds_of_the_solve_cells():
    for name, ms, by in (("girih-7pt-var-f64", 3.205, "bytes"),
                         ("girih-25pt-const-f64", 2.115, "flops")):
        cfg = harness.load_json("configs", name)
        b = roofline.call_bound(cfg, cfg["grid"], 32)
        assert b["seconds"] * 1e3 == pytest.approx(ms, abs=5e-4)
        assert b["by"] == by
        assert b["lups"] == 512 ** 3 * 32


def test_new_pieces_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files of their
    own are found with no edit to the harness."""
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "configs" / "new-cfg.json").write_text(json.dumps(
        {"name": "new-cfg", "operator": "7pt-var", "dtype": "float32"}))
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(
        {"runner": "solve", "steps": 4, "states": 1}))
    (tmp_path / "metrics" / "new_metric.solve.py").write_text(
        "def read(rec):\n    return rec.get('calls')\n")
    bench = {"workloads": [{"name": "new-cell", "config": "new-cfg",
                            "traffic": "new-mix", "chips": 1}]}
    cell = harness.make_cell("new-cell", 3, "cpu", bench, root=tmp_path)
    assert cell.config["operator"] == "7pt-var"
    assert harness.runner(cell.traffic).__name__.endswith(".solve")
    assert harness.reader("new_metric.solve", root=tmp_path)({"calls": 7}) == 7


# A new operator's pieces, as a later change adds them: a configuration,
# the reference's frozen taps, a limits file and a cell. One is the paper's
# 25-point variable-coefficient operator (Listing 4), the other a user
# operator named by its module path, judged by the taps it states.
def _star(slot0, axis_slots):
    """Center tap on array `slot0`, then per (axis, d, slot) the pair
    (+d, -d) along that axis, sharing array `slot`."""
    groups = [["array", slot0, [[0, 0, 0]]]]
    for ax, d, slot in axis_slots:
        off = [0, 0, 0]
        off[ax] = d
        groups.append(["array", slot, [list(off), [-v for v in off]]])
    return groups


NEW_OPERATORS = {
    "25pt-var": {
        "config": {
            "name": "girih-25pt-var-f64", "operator": "25pt-var",
            "dtype": "float64", "grid": [512, 512, 512],
            "draw": {"levels": 1, "coeff_arrays": 13, "coeff_scale": 0.02,
                     "scalars": []},
            "counts": {"flops_per_lup": 37, "input_grids": 14}},
        "reference": {
            "radius": 4, "time_order": 1, "scale": None,
            "groups": _star(0, [(ax, d, 1 + 4 * ax + d - 1)
                                for ax in range(3) for d in range(1, 5)])}},
    "aniso11": {
        "config": {
            "name": "aniso11-f64",
            "operator": "repro_torch.examples.custom_stencil:OP",
            "reference": "aniso11", "dtype": "float64",
            "grid": [256, 256, 256],
            "draw": {"levels": 1, "coeff_arrays": 3, "coeff_scale": 0.08,
                     "scalars": [0.08, 0.04, 0.02]},
            "counts": {"flops_per_lup": 16, "input_grids": 4}},
        "reference": {
            "radius": 3, "time_order": 1, "scale": None,
            "groups": _star(0, [(0, 1, 1), (1, 1, 2)])
            + [["const", d - 1, [[0, 0, d], [0, 0, -d]]] for d in (1, 2, 3)]}},
}

RUN_IN_COPY = """
import json, sys
sys.path[:0] = [{copy!r}, {src!r}]
from girih_bench import harness
from repro_torch.kernels import ops
kw = dict(device="cpu", overrides={{"config": {{"grid": [12, 14, 16]}},
                                   "traffic": {{"steps": 8}}}})
sound = harness.run_cell({cell!r}, 5, 0.3, False, **kw)
ops.mwd = lambda spec, state, coeffs, n_steps, **k: state
broken = harness.run_cell({cell!r}, 5, 0.3, False, **kw)
print(json.dumps([sound, broken]))
"""


def add_operator(copy: Path, name: str) -> str:
    """Adds operator `name`'s files to the benchmark folder `copy` and
    its cell to the manifest beside it; returns the cell's name."""
    new = NEW_OPERATORS[name]
    cfg, cell = new["config"], f"solve-{name}-tiny"
    for path, obj in ((copy / "configs" / f"{cfg['name']}.json", cfg),
                      (copy / "reference" / "operators" / f"{name}.json",
                       new["reference"]),
                      (copy / "limits" / f"{cell}.json", {"gap": 1e-9})):
        assert not path.exists()
        path.write_text(json.dumps(obj))
    bench = harness.manifest(copy.parent / "BENCHMARK.json")
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": f"girih_bench/configs/{cfg['name']}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": cfg["name"],
                               "traffic": "solve", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "solve-7pt-var-512" in m.get("workloads", []):
            m["workloads"].append(cell)
    (copy.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("name", sorted(NEW_OPERATORS))
def test_a_new_operator_needs_only_new_files(tmp_path, name):
    """In a copy of the benchmark folder, a configuration, its reference
    taps, a limits file and a manifest entry make a cell of a new operator:
    a whole tiny run reads `correct` true, and false with a step that
    leaves the state unchanged."""
    from repro_torch.core import ir
    copy = tmp_path / "girih_bench"
    shutil.copytree(ROOT / "girih_bench", copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    cell = add_operator(copy, name)
    # the pieces, found through the `root` of each lookup
    bench = harness.manifest(tmp_path / "BENCHMARK.json")
    c = harness.make_cell(cell, 5, "cpu", bench, root=copy)
    op = ir.resolve_op(c.config["operator"])
    assert c.config["counts"]["flops_per_lup"] == op.flops_per_lup
    assert c.config["counts"]["input_grids"] == 1 + op.n_coeff_arrays
    assert check.limits(cell, root=copy / "limits") == {"gap": 1e-9}
    taps = ref.load(ref.name_of(c.config), root=copy / "reference" /
                    "operators")
    assert taps["groups"] == tuple(
        (k.kind, k.index, tuple(t.offset for t in group))
        for k, group in op.groups)
    # whole runs, in a process that imports the copy
    code = RUN_IN_COPY.format(copy=str(tmp_path), src=str(ROOT / "src"),
                              cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "REPRO_TORCH_PLAN_REGISTRY":
                              str(tmp_path / "plans.json")})
    assert out.returncode == 0, out.stderr[-3000:]
    sound, broken = json.loads(out.stdout.strip().splitlines()[-1])
    assert sound["correct"], sound["check"]
    assert sound["check"]["gap"]["value"] == 0.0
    assert "solve_glups" in sound["metrics"]
    assert not broken["correct"], broken["check"]


def test_arrival_schedule_is_the_layouts_and_its_tenants_the_seeds():
    tr = harness.load_json("traffic", "serve_ragged256")
    due, tenant = serve_open.schedule(tr, 10.0, 5, 3, rate=40.0)
    again = serve_open.schedule(tr, 10.0, 5, 3, rate=40.0)
    other = serve_open.schedule(tr, 10.0, 6, 3, rate=40.0)
    warm = serve_open.schedule(tr, 10.0, 5, 4, rate=40.0)
    assert np.array_equal(due, again[0]) and np.array_equal(tenant, again[1])
    assert np.array_equal(due, other[0])
    assert not np.array_equal(tenant, other[1])
    assert not np.array_equal(due, warm[0])
    assert len(due) == 400 and np.all(np.diff(due) >= 0)
    assert 0.0 <= due[0] and due[-1] < 10.0
    counts = np.bincount(tenant, minlength=tr["tenants"])
    assert counts.max() - counts.min() <= 1
    assert np.diff(due).mean() == pytest.approx(1 / 40.0, rel=0.15)


def test_tenant_grids_are_the_same_set_for_every_seed():
    tr = harness.load_json("traffic", "serve_ragged256")
    a = serve_open.tenant_shapes(tr, 1)
    b = serve_open.tenant_shapes(tr, 2)
    assert a != b and sorted(a) == sorted(b)
    assert len(set(a)) > 1


def test_segments_cover_the_schedule_in_order():
    tr = {"segment_s": 1.0, "segment_requests": 8}
    due = np.sort(np.random.default_rng(0).uniform(0, 5, 60))
    segs = serve_open.segments(due, tr, rate=12.0)
    assert np.array_equal(np.concatenate(segs), np.arange(60))
    assert max(len(s) for s in segs) <= 12
    for s in segs:
        assert due[s[-1]] - due[s[0]] < 8 / 12.0


def test_stall_in_one_segment_shows_in_the_next(monkeypatch):
    """Segmented serving on the CPU: a stall injected at the end of the
    second segment delays the requests that came due meanwhile."""
    from repro_torch.launch import serve
    cell = harness.make_cell("serve-7pt-var-ragged256", 11, "cpu",
                             harness.manifest(), TINY_SERVE)
    drv = serve_open.Runner(cell)
    real, calls = serve.serve_queue, []

    def stalled(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) == 2:
            time.sleep(1.0)
        return out

    monkeypatch.setattr(serve, "serve_queue", stalled)
    rec = drv.window(2.0)
    lat, due = rec["latency_s"], rec["due_s"]
    assert rec["failed"] == 0 and not np.isnan(lat).any()
    first = lat[due < 0.5]
    after = lat[(due >= 0.5) & (due < 1.0)]
    assert len(first) and len(after)
    assert after.max() > first.max() + 0.5
    assert rec["end_to_end"]["serve_p95_ms"] > 500


def test_work_before_the_servers_clock_starts_shows(monkeypatch):
    """The server keys a segment's requests before its own clock starts;
    that time is on the window's clock, so it shows in every latency."""
    from repro_torch.launch import serve
    cell = harness.make_cell("serve-7pt-var-ragged256", 12, "cpu",
                             harness.manifest(), TINY_SERVE)
    drv = serve_open.Runner(cell)
    real = serve.bucket_key

    def slow_key(*a, **k):
        time.sleep(0.1)
        return real(*a, **k)

    monkeypatch.setattr(serve, "bucket_key", slow_key)
    rec = drv.window(1.0)
    assert rec["failed"] == 0 and not np.isnan(rec["latency_s"]).any()
    assert rec["latency_s"].min() >= 0.1


def test_readers_read_a_record_and_skip_an_empty_one():
    ops = [("void mwd_row_kernel<double>", 0.0, 0.2),
           ("Memcpy DtoD", 0.2, 0.21), ("elementwise", 0.21, 0.22)]
    rec = {"calls": 2, "bound_s": 0.003, "window_s": 0.5, "k1_launches": 10,
           "trace": {"device_ops": ops, "busy_s": 0.22, "window_s": 0.5},
           "waits": [0.01, 0.03],
           "launches": [{"size": 4, "launch_s": 0.05, "waste": 0.5},
                        {"size": 2, "launch_s": 0.03, "waste": 0.2}]}
    want = {"call_roofline.solve": 1.2, "k1_roofline.solve": 3.0,
            "k1_launches_per_call.solve": 5.0,
            "outside_k1_ms_per_call.solve": 10.0,
            "device_idle_pct.solve": 56.0, "device_idle_pct.serve": 56.0,
            "queue_wait_ms.serve": 20.0, "batch_size_mean.serve": 3.0,
            "launch_ms.serve": 40.0, "padding_waste_pct.serve": 40.0}
    empty = {"calls": 0, "trace": {"device_ops": [], "busy_s": 0.0,
                                   "window_s": 0.5},
             "waits": [], "launches": []}
    for name, value in want.items():
        read = harness.reader(name)
        assert read(rec) == pytest.approx(value), name
        assert read(empty) is None, name


def test_trace_reduction_unions_and_names_gaps():
    from girih_bench import trace

    def ev(name, a, b, on_device, note=False):
        return (name, on_device, a, b, note)

    events = [ev(trace.WINDOW_SPAN, 1000, 11000, False, True),
              ev(trace.WINDOW_SPAN, 1000, 11000, True, True),
              ev("aten::copy_", 1500, 4500, False),
              ev("k1", 1000, 3000, True), ev("pad", 2000, 4000, True),
              ev("k1", 8000, 9000, True), ev("before", 0, 900, True)]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(0.01)
    assert r["busy_s"] == pytest.approx(0.004)
    assert r["top_ops"][0] == ["k1", pytest.approx(0.003)]
    assert r["idle_gaps"][0] == ["host: python", pytest.approx(0.004)]
    assert r["idle_gaps"][1] == ["host: python", pytest.approx(0.002)]
    events.append(ev("girih.serve_queue", 3000, 9500, False, True))
    events.append(ev("aten::sleepy", 4000, 8000, False))
    gaps = trace.reduce(events)["idle_gaps"]
    assert [g[0] for g in gaps] == ["aten::sleepy", "host: python"]


def test_profiled_window_on_the_cpu_profiler(monkeypatch):
    """The profiler's own events reduce: the window span is found and the
    host names its gaps (no device here, so nothing ran on it)."""
    import torch

    from girih_bench import trace
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    out, r = trace.profiled(lambda: torch.ones(1000).sum())
    assert float(out) == 1000.0
    assert r["window_s"] > 0 and r["busy_s"] == 0 and r["device_ops"] == []


PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT),
                              "REPRO_TORCH_PLAN_REGISTRY": "/nonexistent"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_the_reference_no_program():
    run = loaded(
        "import runpy\n"
        "runpy.run_path('girih_bench/run.py', run_name='girih')\n"
        "from girih_bench import harness, control, find_rate, trace\n"
        "for w in ('solve-7pt-var-512', 'serve-7pt-var-ragged256'):\n"
        "    out = harness.run_cell(w, 1, 0.3, False, device='cpu',\n"
        "        overrides={'config': {'grid': [10, 12, 14]},\n"
        "                   'traffic': {'axes': [10, 12], 'tenants': 2,\n"
        "                               'rate_per_s': 10.0, 'sample': 2,\n"
        "                               'warm_s': 0.1}})\n"
        "    assert out['correct'], out\n"
        "for m in harness.manifest()['per_layer']:\n"
        "    harness.reader(m['name'])\n")
    assert "repro_torch" in run
    assert not run & set(harness.FORBIDDEN)
    reference = loaded("from girih_bench import check, inputs\n"
                       "from girih_bench.reference import stencils\n")
    assert "torch" in reference
    assert not reference & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_run_refuses_without_a_card_and_outside_a_checkout(tmp_path):
    import shutil
    import torch
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "girih_bench/run.py", "--workload",
             "solve-7pt-var-512", "--seed", "1", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
        assert out.returncode != 0 and out.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "girih_bench", tmp_path / "girih_bench")
    out = subprocess.run(
        [sys.executable, "girih_bench/run.py", "--workload",
         "solve-7pt-var-512", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
