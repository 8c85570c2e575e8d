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
from repro.core.mwd import MWDPlan as RPlan
from repro.kernels import ops as rops
from repro.launch import serve as rserve
from repro_torch.core import ir as tir
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


def aniso11(irm):
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [irm.Tap(0, 0, 0, irm.array(0)),
            irm.Tap(-1, 0, 0, irm.array(1)), irm.Tap(1, 0, 0, irm.array(1)),
            irm.Tap(0, -1, 0, irm.array(2)), irm.Tap(0, 1, 0, irm.array(2))]
    taps += [irm.Tap(0, 0, s * d, irm.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return irm.StencilOp("aniso11", tuple(taps),
                         default_scalars=(0.08, 0.04, 0.02))


def ragged_case(name):
    """(port op, two grids of one pow2 class, plan) for a ragged batch."""
    if name == "aniso11":
        return aniso11(tir), [(10, 18, 14), (12, 20, 16)], MWDPlan(12, 2)
    spec = tst.SPECS[name]
    if spec.radius == 1:
        return spec, [(6, 10, 8), (6, 12, 8)], PLAN
    return spec, [(10, 18, 14), (12, 20, 16)], MWDPlan(8, 2)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_serve_queue_pads_mixed_shapes_into_one_launch(name, dtype):
    """Two grid sizes in one pow2 class ride one batched launch (the masked
    twin for the scalar-coefficient ops), each response equal to its own
    unpadded `ops.mwd` (``torch.equal``: a frozen -0.0 reads as +0.0)."""
    spec, grids, plan = ragged_case(name)
    reqs = []
    for i in range(4):
        state, coeffs = tst.make_problem(spec, grids[i % 2], dtype=dtype,
                                         seed=20 + i, device="cpu")
        reqs.append(tserve.StencilRequest(rid=i, spec=spec, state=state,
                                          coeffs=coeffs, n_steps=2))
    results, records = tserve.serve_queue(reqs, max_batch=4,
                                          batch_window_ms=1.0, plan=plan,
                                          ladder="pow2")
    cls = tpad.POW2.padded_shape(grids[1])
    assert [rec["size"] for rec in records] == [4]
    assert records[0]["padded_shape"] == cls and records[0]["plan"] == plan
    assert records[0]["waste"] == rpad.padding_waste(
        [r.state[0].shape for r in reqs], cls)
    for r in reqs:
        want = tops.mwd(spec, r.state, r.coeffs, 2, plan=plan)
        got = results[r.rid]
        assert got[0].shape == r.state[0].shape
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_ragged_masked_twin_resolves_its_own_plan(tmp_path):
    """plan="auto" on a ragged 7pt-const batch resolves the +mask twin's
    plan (its own fingerprint, the b<B> key), not 7pt-const's."""
    spec = tst.SPECS["7pt-const"]
    reg = treg.PlanRegistry(str(tmp_path / "plans.json"))
    probs = [tst.make_problem(spec, sh, seed=s, device="cpu")
             for s, sh in enumerate([(6, 10, 8), (6, 12, 8)])]
    outs, plan, source = tserve._launch_batch(
        spec, [p[0] for p in probs], [p[1] for p in probs], 2, "auto",
        (8, 16, 8), registry=reg)
    twin = tpad.masked_variant(spec)
    assert (plan, source) == reg.resolve(twin, (8, 16, 8), word_bytes=4,
                                         devices_x=1, batch=2)
    for (state, coeffs), got in zip(probs, outs):
        want = tops.mwd(spec, state, coeffs, 2, plan=plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ragged_batch_rejects_mixed_scalars():
    """Scalars are inlined constants: a ragged batch that mixes them is
    refused with the reference's error."""
    spec, rspec = tst.SPECS["7pt-const"], rst.SPECS["7pt-const"]
    s1, c1 = tst.make_problem(spec, (6, 10, 8), seed=0, device="cpu")
    s2, _ = tst.make_problem(spec, (6, 12, 8), seed=1, device="cpu")
    with pytest.raises(ValueError) as got:
        tserve._launch_batch(spec, [s1, s2], [c1, (0.9, 0.2)], 2, PLAN,
                             (8, 16, 8))
    r1, rc1 = rir.make_problem(rspec, (6, 10, 8), seed=0)
    r2, _ = rir.make_problem(rspec, (6, 12, 8), seed=1)
    with pytest.raises(ValueError) as want:
        rserve._launch_batch(rspec, [r1, r2], [rc1, (0.9, 0.2)], 2,
                             RPlan(d_w=4, n_f=2), (8, 16, 8))
    assert str(got.value) == str(want.value)


def test_serve_stencil_mixed_grids_report(capsys):
    """Mixed-size traffic: one pow2 class, one batch, equal results, and
    the reference's waste and class counts."""
    grids = [(6, 10, 8), (6, 12, 8)]
    rep = tserve.serve_stencil(
        "7pt-var", grids, n_steps=2, n_requests=4, max_batch=4,
        batch_window_ms=2.0, arrival_ms=0.1, pad="pow2", plan=PLAN,
        interactive_every=2, deadline_ms=5000.0, device="cpu")
    cls = rpad.POW2.padded_shape(grids[1])
    assert rep["classes"] == {str(cls): 4}
    assert rep["served"] == 4 and rep["rejected"] == 0
    assert rep["deadline_misses"] == 0
    assert rep["padding_waste"] == pytest.approx(
        rpad.padding_waste([grids[i % 2] for i in range(4)], cls))
    spec = tst.SPECS["7pt-var"]
    for i in range(4):
        state, coeffs = tst.make_problem(spec, grids[i % 2], seed=i,
                                         device="cpu")
        want = tops.mwd(spec, state, coeffs, 2, plan=PLAN)
        assert torch.equal(rep["results"][i][0], want[0])
    out = capsys.readouterr().out
    assert "pad=pow2" in out and f"waste={rep['padding_waste']:.3f}" in out


def test_serve_stencil_warms_every_signature_it_serves(monkeypatch, capsys):
    """The warm-up launches every (class, batch size, exact or masked)
    signature the queue then forms, so no first build or plan resolution
    lands in the latency figures."""
    seen = {"warm": set(), "serve": set()}
    phase = ["warm"]
    real = tserve._launch_batch

    def spy(spec, states, coeffs_list, n_steps, plan, padded_shape,
            registry=None):
        exact = all(tuple(s[0].shape) == tuple(padded_shape) for s in states)
        seen[phase[0]].add((tuple(padded_shape), len(states), exact))
        return real(spec, states, coeffs_list, n_steps, plan, padded_shape,
                    registry)

    real_queue = tserve.serve_queue

    def queue(*a, **kw):
        phase[0] = "serve"
        return real_queue(*a, **kw)

    monkeypatch.setattr(tserve, "_launch_batch", spy)
    monkeypatch.setattr(tserve, "serve_queue", queue)
    tserve.serve_stencil("7pt-const", [(8, 10, 8), (8, 16, 8), (8, 12, 8)],
                         n_steps=1, n_requests=7, max_batch=3,
                         batch_window_ms=0.0, arrival_ms=0.0, pad="pow2",
                         plan=PLAN, device="cpu")
    capsys.readouterr()
    assert seen["serve"] and seen["serve"] <= seen["warm"]
    assert {exact for _, _, exact in seen["warm"]} == {True, False}


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


@pytest.mark.parametrize("pad,cls", [("pow2", (8, 16, 8)),
                                     ("8,12,16", (8, 12, 8))])
def test_cli_pads_mixed_grids(capsys, pad, cls):
    """``--pad pow2`` and a rung list put two grid sizes in one class."""
    args = tserve.build_parser().parse_args(
        ["--stencil", "7pt-var", "--pad", pad])
    got, want = tpad.parse_ladder(args.pad), rpad.parse_ladder(pad)
    assert (got.mode, got.rungs) == (want.mode, want.rungs)
    tserve.main(["--stencil", "7pt-const", "--grid", "6,10,8;6,12,8",
                 "--requests", "4", "--steps", "2", "--max-batch", "4",
                 "--arrival-ms", "0", "--pad", pad, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"1 class(es) [{cls}]" in out
    assert "served 4/4" in out and "sizes [4]" in out and "waste=" in out


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


@pytest.mark.parametrize("kind", ["jsonl", "stdout"])
def test_telemetry_sinks_and_aggregator(tmp_path, capsys, kind):
    path = tmp_path / "t.jsonl"
    sink = ttel.make_telemetry(f"jsonl:{path}" if kind == "jsonl"
                               else "stdout")
    sink.emit("launch", size=2, key=(1, 2))
    sink.close()
    if kind == "jsonl":
        rec = json.loads(path.read_text().splitlines()[0])
        assert rec["event"] == "launch" and rec["key"] == [1, 2]
    else:
        assert "serve[launch] size=2" in capsys.readouterr().out
    agg = ttel.Aggregator()
    agg.on_launch("k", 2, 0.01, padded_cells=10, real_cells=8)
    tops.count_plan("explicit")
    agg.on_done(0.02, deadline_missed=True)
    snap = agg.snapshot()
    assert snap["served"] == 2 and snap["deadline_misses"] == 1
    assert snap["padding_waste"] == pytest.approx(0.25)
    assert snap["plan_cache_hit_rate"] == 0.0
    tops.count_plan("registry:measured")
    assert agg.plan_cache_hit_rate == 0.5
    assert agg.snapshot()["counters"]["plan.explicit"][0] == 1
    with pytest.raises(ValueError):
        ttel.make_telemetry("kafka")


def test_serve_stencil_draws_by_device(monkeypatch, capsys):
    """On the CPU the server's requests are `make_problem`'s draws (the
    reference's numbers), each response equal to its own `ops.mwd`; on
    the card `draw_problem` takes `random_problem`'s draws instead."""
    spec = tst.SPECS["7pt-var"]
    rep = tserve.serve_stencil("7pt-var", [(6, 10, 8), (6, 12, 8)], 2, 2,
                               max_batch=2, arrival_ms=0.0, pad="pow2",
                               plan=PLAN, device="cpu", seed=3)
    capsys.readouterr()
    for i, req in enumerate(rep["requests"]):
        state, coeffs = tst.make_problem(spec, req.state[0].shape,
                                         seed=3 + i, device="cpu")
        assert torch.equal(req.state[0], state[0])
        want = tops.mwd(spec, state, coeffs, 2, plan=PLAN)
        assert all(torch.equal(g, w)
                   for g, w in zip(rep["results"][i], want))
    calls = []
    monkeypatch.setattr(tst, "random_problem",
                        lambda *a, **kw: calls.append((a, kw)) or "drawn")
    cuda = torch.device("cuda", 0)
    assert tserve.draw_problem(spec, (6, 10, 8), None, 5, cuda) == "drawn"
    assert calls == [((spec, (6, 10, 8)),
                      dict(dtype=None, seed=5, device=cuda))]
