"""The port's spans and counters (`core.trace`), the server's waits they
split, and the benchmark's readers of them, on the CPU."""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from girih_bench import harness
from girih_bench import trace as bench_trace
from repro_torch.core import registry as treg
from repro_torch.core import scheduler as tsched
from repro_torch.core import stencils as tst
from repro_torch.core import trace
from repro_torch.core.mwd import MWDPlan
from repro_torch.core.trace import Span
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_mwd as tkern
from repro_torch.launch import serve as tserve
from repro_torch.launch import telemetry as ttel

PLAN = MWDPlan(d_w=4, n_f=2, fused=True)
MS = 1_000_000                     # perf_counter_ns of one millisecond


@pytest.fixture(autouse=True)
def _fresh_trace():
    """Every test starts with no kept spans and zeroed counters."""
    trace.reset()
    yield
    trace.reset()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class Sink(ttel.Telemetry):
    """Keeps every event."""

    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))


def test_tracing_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while tracing is off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    assert not trace.enabled()
    with trace.span("girih.x", a=1) as s:
        with trace.span("girih.y") as inner:
            pass
    trace.record("girih.z", 1, 2, rid=0)
    assert s is None and inner is None and trace.spans() == []


def test_spans_nest_in_the_profiler_and_in_memory():
    with cpu_profile() as prof:
        assert trace.enabled()
        with trace.span("girih.outer", a=1) as outer:
            with trace.span("girih.inner") as inner:
                torch.ones(4).sum()
            trace.record("girih.rec", 5, 9, rid=3)
        trace.record("girih.top", 1, 2)
    assert not trace.enabled()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    o, i = events["girih.outer"], events["girih.inner"]
    assert o.start_ns() <= i.start_ns()
    assert (i.start_ns() + i.duration_ns()
            <= o.start_ns() + o.duration_ns())
    assert [s.name for s in trace.spans()] == [
        "girih.inner", "girih.rec", "girih.outer", "girih.top"]
    rec, top = trace.spans("girih.rec")[0], trace.spans("girih.top")[0]
    assert inner.parent is outer and outer.parent is None
    assert rec.parent is outer and top.parent is None
    assert outer.attrs == {"a": 1} and rec.attrs == {"rid": 3}
    assert (rec.start, rec.end, rec.seconds) == (5, 9, 4e-9)
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert inner.under("girih.outer") is outer
    assert inner.under("girih.none") is None


def test_counters_count_and_time_always():
    c = trace.counter("test.c")
    assert trace.counter("test.c") is c
    with c.timed():
        sum(range(1000))
    c.count += 2
    assert c.count == 3 and c.seconds > 0
    assert trace.counts()["test.c"] == (3, c.seconds)
    assert tkern.LAUNCHES is trace.counter("k1.launches")
    trace.reset()
    assert (c.count, c.seconds) == (0, 0.0)


def test_mwd_call_spans_its_steps_and_counts_its_plan(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp_path / "p.json"))
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    want = tops.mwd(spec, state, coeffs, 2, plan="auto")
    assert trace.spans() == []
    assert trace.counts()["plan.model"][0] == 1
    assert trace.counts()["plan.tuner"][0] == 1
    with cpu_profile():
        got = tops.mwd(spec, state, coeffs, 2, plan="auto")
        tops.mwd_batched(spec, [state, state], coeffs, 2, plan=PLAN)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    calls = trace.spans("girih.mwd")
    assert [c.attrs for c in calls] == [{"batch": 1, "steps": 2},
                                        {"batch": 2, "steps": 2}]
    for name in ("girih.mwd.prepare", "girih.mwd.finish"):
        assert [s.under("girih.mwd") for s in trace.spans(name)] == calls
    # an explicit plan is counted, with nothing to resolve
    assert [s.under("girih.mwd") for s in trace.spans("girih.plan")] == [
        calls[0]]
    assert trace.counts()["plan.model"][0] == 2      # memoized: no tuner
    assert trace.counts()["plan.tuner"][0] == 1
    assert trace.counts()["plan.explicit"][0] == 1


def fixed_requests(n_steps=2):
    """Eight requests of two grids of one pow2 class, on fixed arrivals:
    with a 300 ms window and batches of three, the first batch's mates come
    due well after its window opens."""
    spec = tst.SPECS["7pt-var"]
    arrivals = [0.0, 0.15, 0.16, 0.5, 0.51, 1.0, 1.01, 1.3]
    reqs = []
    for i, a in enumerate(arrivals):
        state, coeffs = tst.make_problem(spec, [(6, 10, 8), (6, 12, 8)][i % 2],
                                         seed=i, device="cpu")
        reqs.append(tserve.StencilRequest(rid=i, spec=spec, state=state,
                                          coeffs=coeffs, n_steps=n_steps,
                                          arrival_s=a))
    return reqs


def test_serve_queue_splits_each_wait_and_spans_each_request(tmp_path):
    reqs = fixed_requests()
    sink = Sink()
    registry = treg.PlanRegistry(str(tmp_path / "plans.json"))
    with cpu_profile():
        results, records = tserve.serve_queue(
            reqs, max_batch=3, batch_window_ms=300.0, plan="auto",
            ladder="pow2", telemetry=sink, registry=registry)
    assert sorted(results) == list(range(8))
    spans = trace.spans("girih.serve.request")
    served = [rid for rec in records for rid in rec["rids"]]
    assert sorted(s.attrs["rid"] for s in spans) == sorted(served)
    assert len(spans) == len(served)
    by_rid = {s.attrs["rid"]: s for s in spans}
    launches = [f for e, f in sink.events if e == "launch"]
    (summary,) = [f for e, f in sink.events if e == "summary"]
    assert len(launches) == len(records)
    for rec, ev in zip(records, launches):
        assert ev["rids"] == rec["rids"] and ev["done_s"] == rec["done_s"]
        for k, rid in enumerate(rec["rids"]):
            s = by_rid[rid]
            wait = rec["done_s"] - rec["launch_s"] - reqs[rid].arrival_s
            busy, window = s.attrs["busy_s"], s.attrs["window_s"]
            assert busy >= 0 and window >= 0
            assert busy + window == pytest.approx(wait, abs=1e-6)
            assert s.seconds == pytest.approx(wait, abs=1e-6)
            assert (ev["busy_s"][k], ev["window_s"][k]) == (busy, window)
            assert s.start / 1e9 == pytest.approx(
                summary["clock0_s"] + reqs[rid].arrival_s, abs=1e-6)
            assert s.parent.name == "girih.serve.launch"
            assert rid in s.parent.attrs["rids"]
    for name in ("girih.serve.pad", "girih.serve.crop", "girih.plan"):
        assert len(trace.spans(name)) == len(records)
        assert all(s.under("girih.serve.launch") for s in trace.spans(name))
    assert trace.spans("girih.serve.idle") and trace.spans("girih.serve.window")
    # the mates of a window that opens before they come due wait in it only
    assert any(s.attrs["busy_s"] == 0 and s.attrs["window_s"] > 0
               for s in spans)
    assert summary["counters"]["plan.model"][0] == len(records)
    assert summary["plan_cache_hit_rate"] == 0.0


def test_serve_queue_untraced_reports_waits_and_keeps_no_span():
    sink = Sink()
    reqs = fixed_requests()
    _, records = tserve.serve_queue(reqs, max_batch=3, batch_window_ms=300.0,
                                    plan=PLAN, ladder="pow2", telemetry=sink)
    assert trace.spans() == []
    launches = [f for e, f in sink.events if e == "launch"]
    for rec, ev in zip(records, launches):
        for rid, b, w in zip(ev["rids"], ev["busy_s"], ev["window_s"]):
            wait = rec["done_s"] - rec["launch_s"] - reqs[rid].arrival_s
            assert b + w == pytest.approx(wait, abs=1e-6)
        assert "p50_ms" not in ev and "p99_ms" not in ev


def test_summary_percentiles_cover_every_request(monkeypatch):
    """Past 1024 requests the summary's percentiles are still those of
    every request served, as `queue_summary` computes them."""
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    reqs = [tserve.StencilRequest(rid=i, spec=spec, state=state,
                                  coeffs=coeffs, n_steps=2)
            for i in range(1500)]
    monkeypatch.setattr(
        tserve, "_launch_batch",
        lambda spec, states, coeffs, n, plan, shape, reg=None:
        (list(states), plan, "explicit"))
    sink = Sink()
    _, records = tserve.serve_queue(
        reqs, max_batch=4, batch_window_ms=0.0, plan=PLAN,
        admission=tsched.AdmissionPolicy(max_depth=4096), telemetry=sink)
    (summary,) = [f for e, f in sink.events if e == "summary"]
    want = tserve.queue_summary(reqs, records)
    assert summary["served"] == 1500
    for q in ("p50_ms", "p95_ms", "p99_ms"):
        assert summary[q] == want[q]
    last = np.percentile(want["latencies_s"][-1024:], 50) * 1e3
    assert summary["p50_ms"] < last


def test_bench_trace_names_gaps_by_the_innermost_program_span():
    def ev(name, a, b, on_device, note=False):
        return (name, on_device, a, b, note)

    events = [ev(bench_trace.WINDOW_SPAN, 0, 10000, False, True),
              ev("girih.call", 0, 9000, False, True),
              ev("girih.mwd", 500, 8500, False),
              ev("girih.mwd.tables", 800, 2000, False),
              ev("girih.mwd.launch", 2000, 8000, False),
              ev("aten::copy_", 2100, 4050, False),
              ev("prev_k1", 0, 4000, True), ev("k1", 6000, 8000, True),
              # device-side annotations of program spans are no device work
              ev("girih.mwd.launch", 4100, 6000, True, True),
              ev("girih.mwd", 4000, 6000, True, False)]
    r = bench_trace.reduce(events)
    assert r["busy_s"] == pytest.approx(0.006)
    assert [n for n, *_ in r["device_ops"]] == ["prev_k1", "k1"]
    assert r["idle_gaps"][0] == ["host: python", pytest.approx(0.002)]
    assert r["idle_gaps"][1] == ["girih.mwd.launch", pytest.approx(0.002)]


def spans_of_a_solve_and_a_serve():
    """Two solve calls (one sync each) and one served batch of two."""
    out = []
    for t in (0, 100):
        call = Span("girih.mwd", t * MS, (t + 10) * MS, attrs={"batch": 1})
        tables = Span("girih.mwd.tables", (t + 1) * MS, (t + 6) * MS, call)
        out += [Span("girih.sync", (t + 2) * MS, (t + 6) * MS, tables),
                tables, call]
    launch = Span("girih.serve.launch", 200 * MS, 230 * MS,
                  attrs={"rids": [0, 1]})
    call = Span("girih.mwd", 202 * MS, 228 * MS, launch)
    out += [Span("girih.serve.idle", 150 * MS, 190 * MS),
            Span("girih.serve.window", 195 * MS, 200 * MS),
            Span("girih.serve.request", 190 * MS, 200 * MS, launch,
                 {"rid": 0, "busy_s": 0.005, "window_s": 0.005}),
            Span("girih.serve.request", 197 * MS, 200 * MS, launch,
                 {"rid": 1, "busy_s": 0.0, "window_s": 0.003}),
            Span("girih.mwd.launch", 210 * MS, 212 * MS, call),
            Span("girih.mwd.launch", 215 * MS, 216 * MS, call),
            Span("girih.sync", 216 * MS, 229 * MS, launch), call, launch]
    return out


def test_new_readers_read_spans_and_counters(monkeypatch):
    monkeypatch.setattr(trace, "_SPANS", spans_of_a_solve_and_a_serve())
    monkeypatch.setattr(trace.counter("plan.tuner"), "seconds", 1.5)
    solve = {"calls": 2, "window_s": 0.2}
    serve = {"window_s": 0.4, "launches": [{"size": 2}]}
    # the batched call's sync lies outside its girih.mwd span
    want = {"host_syncs_per_call.solve": (solve, 1.0),
            "mwd_host_ms_per_call.solve": (solve, (6 + 6 + 26) / 2),
            "arrival_idle_pct.serve": (serve, 10.0),
            "window_wait_ms.serve": (serve, 4.0),
            "busy_wait_ms.serve": (serve, 2.5),
            "k1_enqueue_ms.serve": (serve, 12.0),
            "plan_tuner_s.setup": (solve, 1.5)}
    for name, (rec, value) in want.items():
        assert harness.reader(name)(rec) == pytest.approx(value), name
    trace.reset()
    monkeypatch.setattr(trace, "_SPANS", [])
    for name in want:
        if name != "plan_tuner_s.setup":
            assert harness.reader(name)(want[name][0]) is None, name


def test_new_readers_read_nothing_from_a_program_without_spans(
        monkeypatch):
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)
    for name in ("host_syncs_per_call.solve", "mwd_host_ms_per_call.solve",
                 "arrival_idle_pct.serve", "window_wait_ms.serve",
                 "busy_wait_ms.serve", "k1_enqueue_ms.serve",
                 "plan_tuner_s.setup"):
        assert harness.reader(name)({"calls": 2, "window_s": 1.0}) is None
