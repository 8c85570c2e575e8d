"""The port's plan registry against the reference's, and plan="auto" (F1).

The cases of tests/test_registry.py that need no distributed path, on the
port's registry: round trip, keys byte-equal to the reference's, stale
fingerprints, corrupt files, sanitizing, registry-first resolution, the
tune CLI, translation between device specs. (F1, plan="auto" against the
reference's, is tests/test_torch_auto_plan.py.) Every test points the port's
registry variable (and the reference's, where the reference runs) at its
own temporary file.
"""

import json
import math

import pytest
import torch

from repro.core import registry as rreg
from repro_torch.core import autotune as ttune
from repro_torch.core import ir as tir
from repro_torch.core import registry as treg
from repro_torch.core import specs as tspecs
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.kernels import ops as tops
from repro_torch.launch import tune as ttunecli
from test_torch_models import NAMES, pair

SPEC = tst.SPECS["7pt-const"]
GRID = (8, 14, 10)


@pytest.fixture(autouse=True)
def _own_registry(tmp_path, monkeypatch):
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "port-plans.json"))
    monkeypatch.setenv(rreg.ENV_VAR, str(tmp_path / "ref-plans.json"))
    monkeypatch.delenv(tspecs.ENV_SPEC, raising=False)
    monkeypatch.delenv(tspecs.ENV_SPEC_DIR, raising=False)
    tspecs.set_default_spec(None)
    yield
    tspecs.set_default_spec(None)


def test_roundtrip_save_load(tmp_path):
    path = str(tmp_path / "plans.json")
    r = treg.PlanRegistry(path)
    plan = MWDPlan(d_w=4, n_f=2, fused=False)
    r.put(SPEC, GRID, plan, 3.14, source="measured", evals=7)
    got = treg.PlanRegistry(path).get(SPEC, GRID)
    assert got is not None and got.plan == plan
    assert (got.score, got.source, got.evals) == (3.14, "measured", 7)
    assert got.fingerprint == tspecs.fingerprint()
    assert got.spec == "h100-sxm"


@pytest.mark.parametrize("name", NAMES)
def test_keys_byte_equal_to_reference(name):
    rspec, tspec = pair(name)
    for grid in (GRID, (512, 512, 512), (13, 21, 18)):
        for word in (2, 4, 8):
            for dx, batch, variant in ((1, 1, ""), (2, 1, ""), (1, 4, ""),
                                       (1, 1, "vjp")):
                assert treg.plan_key(tspec, grid, word, dx, batch,
                                     variant) == rreg.plan_key(
                    rspec, grid, word, dx, batch, variant)
    with pytest.raises(ValueError):
        treg.plan_key(tspec, GRID, batch=0)
    with pytest.raises(ValueError, match="variant"):
        treg.plan_key(tspec, GRID, variant="bwd")


def test_key_includes_grid_word_devices_and_batch(tmp_path):
    r = treg.PlanRegistry(str(tmp_path / "plans.json"))
    r.put(SPEC, GRID, MWDPlan(d_w=4), 1.0)
    assert r.get(SPEC, (8, 14, 12)) is None
    assert r.get(SPEC, GRID, word_bytes=8) is None
    assert r.get(SPEC, GRID, devices_x=2) is None
    assert r.get(SPEC, GRID, batch=2) is None
    assert r.get(tst.SPECS["7pt-var"], GRID) is None
    assert r.get(SPEC, GRID) is not None


def test_stale_fingerprint_invalidated(tmp_path):
    path = str(tmp_path / "plans.json")
    r = treg.PlanRegistry(path)
    r.put(SPEC, GRID, MWDPlan(d_w=4), 1.0, fingerprint="old-hardware")
    assert r.get(SPEC, GRID) is None
    r.put(SPEC, (9, 9, 9), MWDPlan(d_w=2), 2.0)
    with open(path) as f:
        on_disk = json.load(f)["plans"]
    assert list(on_disk) == [treg.plan_key(SPEC, (9, 9, 9))]


def test_corrupt_or_missing_file_is_empty(tmp_path):
    assert len(treg.PlanRegistry(str(tmp_path / "nope.json"))) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert len(treg.PlanRegistry(str(bad))) == 0
    wrong_ver = tmp_path / "ver.json"
    wrong_ver.write_text(json.dumps({"version": 99, "plans": {
        "x": {"plan": {}, "score": 1, "source": "m", "fingerprint": "f"}}}))
    assert len(treg.PlanRegistry(str(wrong_ver))) == 0


def test_sanitizing_put_and_hand_edited_file(tmp_path):
    r = treg.PlanRegistry(str(tmp_path / "plans.json"))
    entry = r.put(SPEC, GRID, MWDPlan(d_w=8, n_f=3), 1.0)
    assert entry.plan.d_w % entry.plan.n_f == 0
    fp = tspecs.fingerprint()
    path = tmp_path / "edited.json"

    def e(d_w, n_f):
        return {"plan": {"d_w": d_w, "n_f": n_f}, "score": 1.0,
                "source": "measured", "fingerprint": fp}

    path.write_text(json.dumps({"version": treg.SCHEMA_VERSION, "plans": {
        treg.plan_key(SPEC, GRID): e(8, 3),
        treg.plan_key(SPEC, (1, 1, 1)): e(8, 0),
        treg.plan_key(SPEC, (2, 2, 2)): e(0, 1),
        treg.plan_key(tst.SPECS["25pt-const"], GRID): e(6, 1)}}))
    r = treg.PlanRegistry(str(path))
    got = r.get(SPEC, GRID)
    assert got is not None and got.plan.d_w % got.plan.n_f == 0
    nf0 = r.get(SPEC, (1, 1, 1))
    assert nf0 is not None and nf0.plan.n_f >= 1
    assert r.get(SPEC, (2, 2, 2)) is None
    assert r.get(tst.SPECS["25pt-const"], GRID) is None


def test_resolve_registry_first_then_model(tmp_path, monkeypatch):
    r = treg.PlanRegistry(str(tmp_path / "plans.json"))
    cached = MWDPlan(d_w=4, n_f=1)
    r.put(SPEC, GRID, cached, 9.0)
    monkeypatch.setattr(ttune, "autotune",
                        lambda *a, **k: pytest.fail("searched on a hit"))
    assert r.resolve(SPEC, GRID) == (cached, "registry:measured")
    monkeypatch.undo()
    plan, source = r.resolve(SPEC, (8, 14, 12))
    assert source == "model" and plan.d_w % plan.n_f == 0
    score = ttune.model_score(SPEC, (8, 14, 12))
    assert score(plan) >= score(MWDPlan())
    assert math.isfinite(score(plan))
    monkeypatch.setattr(ttune, "autotune",
                        lambda *a, **k: pytest.fail("re-searched a memo"))
    assert r.resolve(SPEC, (8, 14, 12)) == (plan, "model")
    r.save()
    assert treg.plan_key(SPEC, (8, 14, 12)) not in json.load(
        open(r.path))["plans"]                      # never persisted


def test_ops_mwd_auto_uses_registry(monkeypatch):
    path = treg.default_registry().path
    assert path.endswith("port-plans.json")
    r = treg.PlanRegistry(path)
    r.put(SPEC, GRID, MWDPlan(d_w=4, n_f=2), 5.0)
    r.put(SPEC, GRID, MWDPlan(d_w=2, n_f=1, fused=False), 6.0, batch=2)
    treg._REGISTRIES.pop(path, None)            # reload what was written
    monkeypatch.setattr(ttune, "autotune",
                        lambda *a, **k: pytest.fail("searched on a hit"))
    state, coeffs = tst.make_problem(SPEC, GRID, seed=0, device="cpu")
    got = tops.mwd(SPEC, state, coeffs, 3, plan="auto")
    want = tops.mwd(SPEC, state, coeffs, 3, d_w=4, n_f=2, fused=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the batched call resolves its own b2 entry
    batched = tops.mwd_batched(SPEC, [state, state], [coeffs, coeffs], 3,
                               plan="auto")
    want = tops.mwd_batched(SPEC, [state, state], [coeffs, coeffs], 3,
                            d_w=2, n_f=1, fused=False)
    assert all(torch.equal(a, b) for a, b in zip(batched, want))


def test_ops_mwd_rejects_unknown_plan_string():
    state, coeffs = tst.make_problem(SPEC, GRID, seed=0, device="cpu")
    with pytest.raises(ValueError, match="auto"):
        tops.mwd(SPEC, state, coeffs, 1, plan="fastest")


def counting_measure_score(calls):
    def fake(spec, grid_shape, *a, **k):
        inner = ttune.model_score(spec, grid_shape)

        def score(plan):
            s = inner(plan)
            if not math.isinf(s):
                calls["n"] += 1
                score.measurements += 1
            return s

        score.measurements = 0
        return score
    return fake


def test_tune_cli_second_run_measures_nothing(tmp_path, monkeypatch,
                                              capsys):
    """The real measured path on the CPU, then a free second run."""
    path = str(tmp_path / "plans.json")
    args = ["--stencil", "7pt-const", "--registry", path, "--device", "cpu",
            "--grid", "6,10,8", "--max-evals", "3", "--reps", "1",
            "--steps", "2"]
    first = ttunecli.main(args)
    assert first[0]["source"] == "measured"
    assert first[0]["measurements"] > 0
    second = ttunecli.main(args + ["--expect-cached"])
    assert second[0]["source"] == "cached"
    assert second[0]["measurements"] == 0
    assert second[0]["plan"] == first[0]["plan"]
    out = capsys.readouterr().out
    assert "7pt-const,cached," in out and "device=cpu" in out
    # --expect-cached exits 3 when something is measured
    calls = {"n": 0}
    monkeypatch.setattr(ttune, "measure_score", counting_measure_score(calls))
    with pytest.raises(SystemExit) as exc:
        ttunecli.main(["--stencil", "7pt-var", "--registry", path,
                       "--expect-cached"])
    assert exc.value.code == 3 and calls["n"] > 0


def test_tune_measured_upgrades_model_entry(tmp_path, monkeypatch):
    calls = {"n": 0}
    monkeypatch.setattr(ttune, "measure_score", counting_measure_score(calls))
    path = str(tmp_path / "plans.json")
    model = ttunecli.main(["--stencil", "7pt-const", "--registry", path,
                           "--model-only"])
    assert model[0]["source"] == "model" and calls["n"] == 0
    measured = ttunecli.main(["--stencil", "7pt-const", "--registry", path])
    assert measured[0]["source"] == "measured"
    assert measured[0]["measurements"] == calls["n"] > 0
    again = ttunecli.main(["--stencil", "7pt-const", "--registry", path])
    assert again[0]["source"] == "cached"


def test_same_name_ops_do_not_collide(tmp_path):
    base = [tir.Tap(0, 0, 0, tir.const(0)),
            tir.Tap(0, 0, -1, tir.const(1)), tir.Tap(0, 0, 1, tir.const(1))]
    op_a = tir.StencilOp("custom", tuple(base))
    op_b = tir.StencilOp("custom", tuple(base + [
        tir.Tap(0, -1, 0, tir.const(1)), tir.Tap(0, 1, 0, tir.const(1))]))
    assert treg.plan_key(op_a, GRID) != treg.plan_key(op_b, GRID)
    r = treg.PlanRegistry(str(tmp_path / "plans.json"))
    r.put(op_a, GRID, MWDPlan(d_w=4, n_f=1), 1.0)
    r.put(op_b, GRID, MWDPlan(d_w=8, n_f=2), 2.0)
    assert r.get(op_a, GRID).plan == MWDPlan(d_w=4, n_f=1)
    assert r.get(op_b, GRID).plan == MWDPlan(d_w=8, n_f=2)


def test_plan_key_rejects_bare_names():
    with pytest.raises(TypeError, match="StencilOp"):
        treg.plan_key("7pt-const", GRID)


def test_legacy_keys_dropped_or_upgraded(tmp_path):
    fp = tspecs.fingerprint()
    path = tmp_path / "plans.json"
    entry = {"plan": {"d_w": 4, "n_f": 2}, "score": 1.0,
             "source": "measured", "fingerprint": fp}
    legacy = f"7pt-const|{GRID[0]}x{GRID[1]}x{GRID[2]}|w4|dx1"
    pre_batch = treg.plan_key(SPEC, (9, 9, 9)).rsplit("|", 1)[0]
    good = treg.plan_key(SPEC, GRID)
    path.write_text(json.dumps({"version": treg.SCHEMA_VERSION, "plans": {
        legacy: entry, good: dict(entry, score=2.0),
        pre_batch: dict(entry, score=3.0)}}))
    r = treg.PlanRegistry(str(path))
    assert len(r) == 2
    assert r.get(SPEC, GRID).score == 2.0
    assert r.get(SPEC, (9, 9, 9)).score == 3.0          # read as b1
    r.save()
    assert sorted(json.load(open(path))["plans"]) == sorted(
        [good, treg.plan_key(SPEC, (9, 9, 9))])


def test_never_touches_the_reference_registry(tmp_path, monkeypatch):
    monkeypatch.delenv(treg.ENV_VAR)
    monkeypatch.chdir(tmp_path)
    r = treg.default_registry()
    assert r.path == treg.DEFAULT_PATH
    assert ".repro_torch_cache" in r.path and ".repro_cache" not in \
        r.path.replace(".repro_torch_cache", "")
    r.put(SPEC, GRID, MWDPlan(d_w=4), 1.0)
    assert (tmp_path / ".repro_torch_cache" / "plans.json").exists()
    assert not (tmp_path / ".repro_cache").exists()
    treg._REGISTRIES.pop(treg.DEFAULT_PATH, None)


# ---------------------------------------------------------------------------
# Translation across device specs
# ---------------------------------------------------------------------------

def _other_spec_dir(tmp_path, monkeypatch, **changes):
    raw = tspecs.get_spec("h100-sxm").to_dict()
    raw.update(name="slow-card", **changes)
    d = tmp_path / "specs"
    d.mkdir(exist_ok=True)
    (d / "slow-card.json").write_text(json.dumps(raw))
    monkeypatch.setenv(tspecs.ENV_SPEC_DIR, str(d))


def _foreign_registry(tmp_path, monkeypatch):
    """One measured slow-card entry, reopened under h100-sxm."""
    _other_spec_dir(tmp_path, monkeypatch, hbm_bw=1e12,
                    cluster_barrier_s=2e-6)
    path = str(tmp_path / "plans.json")
    tspecs.set_default_spec("slow-card")
    treg.PlanRegistry(path).put(SPEC, GRID, MWDPlan(d_w=4, n_f=2), 0.5,
                                source="measured", evals=9)
    tspecs.set_default_spec(None)
    return treg.PlanRegistry(path)


def test_resolve_translates_foreign_plan_without_measuring(tmp_path,
                                                           monkeypatch):
    r = _foreign_registry(tmp_path, monkeypatch)
    monkeypatch.setattr(ttune, "autotune",
                        lambda *a, **k: pytest.fail("must not autotune"))
    plan, source = r.resolve(SPEC, GRID)
    assert (plan, source) == (MWDPlan(d_w=4, n_f=2), "translated:slow-card")
    assert r.resolve(SPEC, GRID) == (plan, source)
    r.save()
    entry = json.load(open(r.path))["plans"][treg.plan_key(SPEC, GRID)]
    assert (entry["spec"], entry["source"]) == ("slow-card", "measured")
    stats = treg.PlanRegistry(r.path).stats()
    assert stats["foreign"] == 1 and stats["spec"] == "h100-sxm"


def test_translation_rescales_by_the_model_ratio(tmp_path, monkeypatch):
    r = _foreign_registry(tmp_path, monkeypatch)
    foreign = r.foreign_entry(SPEC, GRID)
    h100, slow = tspecs.get_spec("h100-sxm"), tspecs.get_spec("slow-card")
    out = treg.translate_entry(foreign, SPEC, GRID, to_spec=h100)
    ratio = (ttune.model_score(SPEC, GRID, 4, h100)(foreign.plan)
             / ttune.model_score(SPEC, GRID, 4, slow)(foreign.plan))
    assert out.score == pytest.approx(foreign.score * ratio)
    assert ratio > 1.0            # the faster card scores higher
    assert (out.source, out.spec) == ("translated:slow-card", "h100-sxm")
    assert out.fingerprint == tspecs.fingerprint(h100)


def test_translation_refusals(tmp_path, monkeypatch):
    import dataclasses
    r = _foreign_registry(tmp_path, monkeypatch)
    foreign = r.foreign_entry(SPEC, GRID)
    h100 = tspecs.get_spec("h100-sxm")
    # same spec, legacy entry, unknown spec: nothing to translate
    assert treg.translate_entry(foreign, SPEC, GRID,
                                to_spec=tspecs.get_spec("slow-card")) is None
    for spec_name in ("", "decommissioned-card"):
        bad = dataclasses.replace(foreign, spec=spec_name)
        assert treg.translate_entry(bad, SPEC, GRID, to_spec=h100) is None
    # kernel-invalid for the op (2R = 8 does not divide 4)
    assert treg.translate_entry(foreign, tst.SPECS["25pt-var"], GRID,
                                to_spec=h100) is None
    # rings that do not fit the target's shared memory
    tiny = dataclasses.replace(h100, name="tiny-smem",
                               smem_block_bytes=1024)
    assert treg.translate_entry(foreign, SPEC, GRID, to_spec=tiny) is None
