"""The port's stencil server and its queue policy vs the JAX reference."""

import json
import math

import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import padding as rpad
from repro.core import scheduler as rsched
from repro.core import stencils as rst
from repro.kernels import ops as rops
from repro.launch import serve as rserve
from repro_torch.core import padding as tpad
from repro_torch.core import registry as treg
from repro_torch.core import scheduler as tsched
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import telemetry as ttel

PLAN = MWDPlan(d_w=4, n_f=2, fused=True)


def assert_within(got, want, tol):
    atol, rtol = tol
    g = got.double().numpy()
    w = np.asarray(want).astype(np.float64)
    err = np.abs(g - w)
    assert np.all(err <= atol + rtol * np.abs(w)), float(err.max())


def test_serve_stencil_matches_reference_per_request(capsys):
    grid, steps = (8, 14, 10), 3
    rep = tserve.serve_stencil("7pt-var", grid, steps, 4, max_batch=2,
                               arrival_ms=0.0, plan=PLAN, device="cpu")
    assert rep["served"] == 4 and rep["rejected"] == 0
    assert rep["batch_sizes"] == [2, 2]
    assert rep["source"] == "explicit" and rep["device"] == "cpu"
    assert rep["p99_ms"] >= rep["p50_ms"] >= 0.0
    rspec, tspec = rst.SPECS["7pt-var"], tst.SPECS["7pt-var"]
    for rid in range(4):
        rstate, rcoeffs = rir.make_problem(rspec, grid, seed=rid)
        want = rops.mwd(rspec, rstate, rcoeffs, steps, d_w=PLAN.d_w,
                        n_f=PLAN.n_f)
        got = rep["results"][rid]
        for g, w in zip(got, want):
            assert_within(g, w, tspec.tolerance("f32"))
        state, coeffs = tst.make_problem(tspec, grid, seed=rid, device="cpu")
        seq = tops.mwd(tspec, state, coeffs, steps, plan=PLAN)
        for g, s in zip(got, seq):
            assert torch.equal(g, s)
    assert "served 4/4" in capsys.readouterr().out


def test_serve_stencil_auto_plan_is_the_default(capsys, tmp_path,
                                                monkeypatch):
    """plan="auto" resolves registry-first; on an empty registry the
    model-scored tuner's plan for the batch-2 launch (source "model")."""
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "plans.json"))
    rep = tserve.serve_stencil("7pt-const", (6, 18, 8), 2, 2, max_batch=2,
                               arrival_ms=0.0, device="cpu")
    want = treg.resolve_plan(tst.SPECS["7pt-const"], (6, 18, 8),
                             word_bytes=4, batch=2)
    assert (rep["plan"], rep["source"]) == want
    assert want[1] == "model"
    assert all(r["plan_source"] == "model" and r["plan"] == want[0]
               for r in rep["records"])
    capsys.readouterr()


def test_serve_queue_buckets_and_limits_batches():
    spec = tst.SPECS["7pt-const"]
    reqs = []
    for i in range(5):
        shape = (8, 10, 8) if i % 2 == 0 else (8, 12, 8)
        state, coeffs = tst.make_problem(spec, shape, seed=i, device="cpu")
        reqs.append(tserve.StencilRequest(rid=i, spec=spec, state=state,
                                          coeffs=coeffs, n_steps=2))
    results, records = tserve.serve_queue(reqs, max_batch=2, plan=PLAN)
    assert sorted(results) == list(range(5))
    assert [r["size"] for r in records] == [2, 2, 1]
    for rec in records:
        assert len({tuple(reqs[i].state[0].shape) for i in rec["rids"]}) == 1
    for r in reqs:
        want = tops.mwd(spec, r.state, r.coeffs, 2, plan=PLAN)
        assert torch.equal(results[r.rid][0], want[0])


def test_serve_queue_admission_and_lanes():
    spec = tst.SPECS["7pt-const"]
    state, coeffs = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    reqs = [tserve.StencilRequest(rid=i, spec=spec, state=state,
                                  coeffs=coeffs, n_steps=1,
                                  priority="interactive" if i == 3
                                  else "batch")
            for i in range(4)]
    results, records = tserve.serve_queue(
        reqs, max_batch=1, plan=PLAN,
        admission=tsched.AdmissionPolicy(max_depth=2))
    assert isinstance(results[2], tserve.Rejected)
    assert results[2].retry_after_s > 0
    assert records[0]["rids"] == [3] and records[0]["lane"] == "interactive"
    assert [r["rids"][0] for r in records] == [3, 0, 1]


def test_ragged_ladders_are_refused():
    spec = tst.SPECS["7pt-const"]
    state, coeffs = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    req = tserve.StencilRequest(0, spec, state, coeffs, 1)
    with pytest.raises(NotImplementedError, match="exact"):
        tserve.serve_queue([req], ladder="pow2")
    with pytest.raises(NotImplementedError, match="exact"):
        tserve.serve_stencil("7pt-const", (6, 10, 8), 1, 1, pad="8,16",
                             device="cpu")
    with pytest.raises(NotImplementedError, match="ragged"):
        tserve._launch_batch(spec, [state], [coeffs], 1, PLAN, (8, 16, 8))


def test_bucket_key_matches_reference_fields():
    rspec, tspec = rst.SPECS["7pt-const"], tst.SPECS["7pt-const"]
    rstate, rcoeffs = rir.make_problem(rspec, (6, 10, 8), seed=0)
    tstate, tcoeffs = tst.make_problem(tspec, (6, 10, 8), seed=0,
                                       device="cpu")
    want = rserve.bucket_key(rspec, rstate, rcoeffs, 3)
    got = tserve.bucket_key(tspec, tstate, tcoeffs, 3)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[3:] == want[3:]
    assert got[2] == "f32"
    other = tserve.bucket_key(tspec, tstate, (0.4, 0.2), 3)
    assert other != got
    bf = tserve.bucket_key(tspec, (tstate[0].bfloat16(),) * 2, tcoeffs, 3)
    assert bf != got


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve_stencil("7pt-const", (6, 10, 8), 1, 1)


def test_cli_serves_on_the_cpu(capsys):
    tserve.main(["--stencil", "7pt-const", "--grid", "6,10,8",
                 "--requests", "3", "--steps", "2", "--max-batch", "3",
                 "--arrival-ms", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3/3" in out and "sizes [3]" in out
    args = tserve.build_parser().parse_args(["--stencil", "7pt-var"])
    assert args.device == "cuda" and args.pad == "exact"


# ---------------------------------------------------------------------------
# Queue policy, ladders and telemetry: same behaviour as the reference
# ---------------------------------------------------------------------------

def test_lane_queue_matches_reference():
    for mod in (rsched, tsched):
        q = mod.LaneQueue(mod.AdmissionPolicy(max_depth=2,
                                              retry_after_s=0.1))
        assert q.offer("a") is None and q.offer("b") is None
        assert q.offer("c") == pytest.approx(0.1)
        assert q.offer("i", "interactive") is None
        assert q.head() == ("i", "interactive")
        assert list(q.items()) == ["i", "a", "b"]
        q.remove(["i", "a"])
        assert len(q) == 1 and q.depth("batch") == 1
        with pytest.raises(ValueError):
            q.offer("x", "bulk")
        with pytest.raises(ValueError):
            mod.AdmissionPolicy(max_depth=0)


def test_window_close_matches_reference():
    for args in ((1.0, 0.005), (1.0, 0.005, 1.002, 0.001),
                 (1.0, 0.005, 0.9, 0.0), (2.0, 0.01, math.inf, 0.5)):
        assert tsched.window_close_s(*args) == rsched.window_close_s(*args)


def test_service_estimator_takes_dispatch_time_as_an_argument():
    est = tsched.ServiceEstimator()
    assert est.dispatch_s == 0.0
    assert est.predict("k", 4) == 0.0
    est.observe("k", 2, 0.02)
    assert est.predict("k", 4) == pytest.approx(0.04)
    est2 = tsched.ServiceEstimator(alpha=1.0, dispatch_s=0.001)
    est2.observe("k", 2, 0.021)
    assert est2.predict("k", 3) == pytest.approx(3 * 0.01 + 0.001)
    with pytest.raises(ValueError):
        tsched.ServiceEstimator(alpha=0.0)
    with pytest.raises(ValueError):
        tsched.ServiceEstimator(dispatch_s=-1.0)


def test_padding_ladder_matches_reference():
    for spec in (None, "exact", "pow2", "8,16,32", "5"):
        r, t = rpad.parse_ladder(spec), tpad.parse_ladder(spec)
        for shape in ((3, 9, 17), (8, 16, 40), (1, 1, 1)):
            assert t.padded_shape(shape) == r.padded_shape(shape)
    assert tpad.next_pow2(17) == rpad.next_pow2(17) == 32
    shapes = [(4, 6, 8), (3, 6, 8)]
    assert (tpad.padding_waste(shapes, (4, 8, 8))
            == rpad.padding_waste(shapes, (4, 8, 8)))
    a = torch.arange(4 * 5 * 6.).reshape(4, 5, 6)
    cur, prev = tpad.crop_state((a, a + 1), (2, 3, 4))
    assert cur.shape == (2, 3, 4) and torch.equal(prev, a[:2, :3, :4] + 1)
    with pytest.raises(ValueError):
        tpad.PaddingLadder("rungs")


def test_telemetry_sinks_and_aggregator(tmp_path, capsys):
    path = tmp_path / "t.jsonl"
    sink = ttel.make_telemetry(f"jsonl:{path}")
    tee = ttel.TeeTelemetry(sink, ttel.make_telemetry("stdout"))
    tee.emit("launch", size=2, key=(1, 2))
    tee.close()
    rec = json.loads(path.read_text().splitlines()[0])
    assert rec["event"] == "launch" and rec["key"] == [1, 2]
    assert "serve[launch] size=2" in capsys.readouterr().out
    agg = ttel.Aggregator()
    agg.on_launch("k", 2, 0.01, padded_cells=10, real_cells=8,
                  plan_source="default")
    agg.on_done(0.02, deadline_missed=True)
    snap = agg.snapshot()
    assert snap["served"] == 2 and snap["deadline_misses"] == 1
    assert snap["padding_waste"] == pytest.approx(0.25)
    assert snap["plan_cache_hit_rate"] == 0.0
    with pytest.raises(ValueError):
        ttel.make_telemetry("kafka")
