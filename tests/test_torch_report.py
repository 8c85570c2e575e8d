"""The port's report and precision gate against the reference's.

`repro_torch.launch.report`'s tables are held to the strings of
`benchmarks/experiments.py` on the same points (exact string equality; the
a-priori model's column is named for the H100 instead of the v5e), its
`--check` passes on the committed `src/repro_torch/results/` and fails on
an edited copy; `repro_torch.launch.precision_gate` passes and fails where
`benchmarks/precision_gate.py` does on the same points.
"""

import json
import shutil

import pytest

from benchmarks import experiments as rrep
from benchmarks import precision_gate as rgate
from repro.core import models as rmodels
from repro_torch.core import models as tmodels
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.launch import precision_gate as tgate
from repro_torch.launch import report as trep
from repro_torch.launch import sweep as tsweep


def fixture_point(stencil, grid, mode, t_s, *, dtype="f32", batch=1,
                  k1_t_s=None, d_w=8, n_f=2):
    """One sweep point in the port's schema: the port's own model columns
    for the shape, a made-up measured time."""
    spec = tst.SPECS[stencil]
    word = 2 if dtype == "bf16" else 4
    plan = MWDPlan(d_w=d_w, n_f=n_f, fused=mode == "fused")
    ps = tsweep.PointSpec(spec, grid, 8, mode == "fused", batch, word, dtype)
    point = {"key": ps.key, "stencil": stencil,
             "op_fingerprint": spec.fingerprint, "grid": list(grid),
             "n_steps": 8, "mode": mode, "batch": batch, "word_bytes": word,
             "dtype": dtype, "distributed": False,
             "plan": {"d_w": d_w, "n_f": n_f, "t_block": 0, "tg_x": 1,
                      "block_x": 0, "fused": mode == "fused"},
             "plan_source": "tuned:measured",
             "device": {"name": "NVIDIA H100 80GB HBM3",
                        "power_limit": "700.00 W"},
             "spec": "h100-sxm", "hw_fingerprint": "fp-test"}
    point.update(tsweep.model_point(spec, grid, 8, plan, batch, word))
    point["measured"] = {"t_s": t_s, "glups": point["lups"] / t_s / 1e9}
    if k1_t_s is not None:
        point["measured"]["k1_t_s"] = k1_t_s
    return point


def fixture_points():
    pts = []
    for i, n in enumerate((32, 48, 64)):
        for j, stencil in enumerate(("7pt-var", "25pt-const")):
            t = 1e-3 * (i + 1) * (j + 1.5)
            pts.append(fixture_point(stencil, (n, n, n), "fused", t,
                                     k1_t_s=0.8 * t))
        pts.append(fixture_point("7pt-var", (n, n, n), "row", 2.2e-3 * n / 32,
                                 k1_t_s=1.5e-3 * n / 32))
    pts.append(fixture_point("7pt-var", (48, 48, 48), "fused", 2.1e-3,
                             dtype="bf16"))
    pts.append(fixture_point("7pt-var", (32, 32, 32), "fused", 2.5e-3,
                             batch=2))
    return pts


def write_results(tmp_path, pts, name="sweep.json"):
    d = tmp_path / "results"
    d.mkdir(exist_ok=True)
    with open(d / name, "w") as f:
        json.dump({"version": 1, "hw_fingerprint": "fp-test",
                   "points": {p["key"]: p for p in pts}}, f)
    return str(d)


def ref_label(text):
    return text.replace("v5e model GLUP/s", f"{trep.MODEL_LABEL} GLUP/s")


def test_tables_equal_the_references_strings():
    pts = fixture_points()
    fit_pts = [{"key": p["key"], "flops": p["flops"],
                "hbm_bytes": p["traffic"]["hbm_bytes"],
                "measured_s": p["measured"]["t_s"],
                "model_s": p["model"]["t_s"]} for p in pts]
    tres, rres = (tmodels.model_residuals(fit_pts),
                  rmodels.model_residuals(fit_pts))
    tcal = tmodels.EcmCalibration(**tres["calibration"])
    rcal = rmodels.EcmCalibration(**rres["calibration"])
    for sel in (pts, pts[:3], [p for p in pts if p["mode"] == "row"]):
        assert trep.glups_table(sel, tcal) == ref_label(
            rrep.glups_table(sel, rcal))
        assert trep.glups_table(sel, None) == ref_label(
            rrep.glups_table(sel, None))
        assert trep.blup_table(sel) == rrep.blup_table(sel)
        assert trep.energy_table(sel) == rrep.energy_table(sel)
    assert trep.residual_table(tres) == rrep.residual_table(rres)
    assert trep.dtype_table(pts) == rrep.dtype_table(pts)


def test_render_sections_and_provenance(tmp_path):
    results = write_results(tmp_path, fixture_points())
    text = trep.render(results)
    for heading in ("## 1. Throughput vs grid size",
                    "## 1b. ECM terms", "## 2. Memory traffic vs grid size",
                    "## 2b. Reduced-precision streams",
                    "## 3. Energy vs tuning choice",
                    "## 4. Model validation", "### 4b. K1's phase model"):
        assert heading in text, heading
    assert "NVIDIA H100 80GB HBM3, power limit 700.00 W" in text
    assert "| points | 9 |" in text           # the points that timed K1
    assert "| `k1_phase_s` |" in text
    assert "## 5." not in text                 # distributed: item 11
    assert text == trep.render(results)        # deterministic


def test_check_mode_passes_and_fails_on_drift(tmp_path):
    results = write_results(tmp_path, fixture_points())
    out = str(tmp_path / "REPRODUCTION.md")
    assert trep.main(["--results", results, "--out", out]) == 0
    assert trep.main(["--results", results, "--out", out, "--check"]) == 0
    with open(out, "a") as f:
        f.write("tampered\n")
    assert trep.main(["--results", results, "--out", out, "--check"]) == 2
    assert trep.main(["--results", results, "--out",
                      str(tmp_path / "missing.md"), "--check"]) == 2


def test_committed_report_matches_committed_results(tmp_path):
    """`python -m repro_torch.launch.report --check` on the committed
    results, and on a copy with one measured time edited."""
    assert trep.main(["--check"]) == 0
    copy = tmp_path / "results"
    shutil.copytree(tsweep.RESULTS_DIR, copy)
    path = copy / "sweep.json"
    raw = json.loads(path.read_text())
    key = sorted(raw["points"])[0]
    raw["points"][key]["measured"]["t_s"] *= 1.5
    path.write_text(json.dumps(raw))
    assert trep.main(["--results", str(copy), "--out",
                      str(copy / "REPRODUCTION.md"), "--check"]) == 2


def test_committed_sweep_passes_the_precision_gate():
    assert tgate.main(["--results", tsweep.DEFAULT_RESULTS]) == 0


@pytest.mark.parametrize("case", ["pass", "ratio", "missing", "residual",
                                  "few"])
def test_precision_gate_equals_reference(case, tmp_path):
    pts = fixture_points()
    if case == "ratio":          # a reduced stream counted at the full word
        for p in pts:
            if p["dtype"] == "bf16":
                p["traffic"]["b_per_lup"] *= 2
    elif case == "missing":
        pts = [p for p in pts if p["dtype"] != "bf16"]
    elif case == "residual":     # one point 100x off the line
        pts[2]["measured"]["t_s"] *= 100
    elif case == "few":
        pts = [p for p in pts if p["dtype"] == "bf16"]
        pts += [fixture_point("7pt-var", (48, 48, 48), "fused", 2e-3)]
    path = str(tmp_path / "sweep.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "points": {p["key"]: p for p in pts}}, f)
    args = ["--results", path, "--max-residual", "3.0"]
    got, want = tgate.main(args), rgate.main(args)
    assert got == want == (0 if case == "pass" else 1)
    for mod in (tgate, rgate):
        loaded = mod.load_points(path)
        assert bool(mod.traffic_gate(loaded, "7pt-var", "bf16", 0.6)) == (
            case in ("ratio", "missing"))
    assert tgate.residual_gate(tgate.load_points(path), 3.0) == \
        rgate.residual_gate(rgate.load_points(path), 3.0)
