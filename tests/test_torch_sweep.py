"""The port's grid-size sweep against the reference's `repro.launch.sweep`.

Keys, ladders and lattices are held equal to the reference's (exact
strings and tuples); `calibration_summary` equal as a string on the same
points. `run_sweep` runs on the CPU at tiny grids (`device="cpu"`: the
plain version of K1 behind `ops.mwd`) and must write every key of the
reference's results schema with the same types, resume to zero
measurements, and fit and save the ECM calibration as the reference does.
The distributed leg and the scaling lattice wait for the distributed port
and must refuse loudly.
"""

import json
import os

import pytest

from repro.core import stencils as rst
from repro.launch import sweep as rsweep
from repro_torch.core import registry as treg
from repro_torch.core import stencils as tst
from repro_torch.launch import sweep as tsweep
from test_torch_models import NAMES, pair


@pytest.mark.parametrize("name", NAMES)
def test_point_key_equals_reference(name):
    rspec, tspec = pair(name)
    for grid in ((6, 10, 8), (512, 512, 512)):
        for steps in (2, 8):
            for fused in (True, False):
                for batch in (1, 4):
                    for word, dt in ((4, "f32"), (2, "bf16"), (2, "fp16"),
                                     (8, "f64")):
                        args = (grid, steps, fused, batch, word)
                        assert tsweep.point_key(
                            tspec, *args, dtype_name=dt) == \
                            rsweep.point_key(rspec, *args, dtype_name=dt)
    ps = tsweep.PointSpec(tspec, (6, 10, 8), 2, True, 1, 2, "bf16")
    assert ps.key == rsweep.PointSpec(rspec, (6, 10, 8), 2, True, 1, 2,
                                      dtype_name="bf16").key


def test_ladder_and_lattice_equal_reference():
    sizes = (128, 256, 384, 512, 640, 768)
    assert tsweep.ladder(sizes) == rsweep.ladder(sizes)
    assert tsweep.ladder(["8", "12"]) == [(8, 8, 8), (12, 12, 12)]
    tspecs = list(tst.SPECS.values())
    rspecs = list(rst.SPECS.values())
    for modes, batches, dt, word in ((("fused",), (1,), "f32", 4),
                                     (("fused", "row"), (1, 2), "bf16", 2)):
        got = tsweep.iter_points(tspecs, tsweep.ladder((8, 12)), modes,
                                 batches, 8, word, dt)
        want = rsweep.iter_points(rspecs, rsweep.ladder((8, 12)), modes,
                                  batches, 8, word, dtype_name=dt)
        assert [p.key for p in got] == [p.key for p in want]


def _fake_points(n=6):
    pts = []
    for i in range(n):
        f, b = 1e9 * (i + 1), 3e9 * (n - i)
        pts.append({"flops": f, "traffic": {"hbm_bytes": b},
                    "measured": {"t_s": f / 5e12 + b / 2e12 + 1e-4
                                 + 1e-5 * (i % 2)}})
    return pts


def test_calibration_summary_equals_reference():
    for n in (2, 3, 6):
        assert tsweep.calibration_summary(_fake_points(n)) == \
            rsweep.calibration_summary(_fake_points(n))
    assert tsweep.calibration_summary(_fake_points(2)) == ""


def _tiny(tmp_path, monkeypatch, **kw):
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "plans.json"))
    path = str(tmp_path / "results" / "sweep.json")
    specs = [tst.SPECS["7pt-const"], tst.SPECS["25pt-var"]]
    grids = [(18, 20, 16), (20, 24, 18)]
    return tsweep.run_sweep(specs, grids, results_path=path, n_steps=2,
                            reps=1, verbose=False, device="cpu", **kw), path


def _schema(d, prefix=""):
    out = {}
    for k, v in d.items():
        out[prefix + k] = type(v).__name__ if v is not None else "None"
        if isinstance(v, dict) and k not in ("points", "plan"):
            out.update(_schema(v, prefix + k + "."))
    return out


def test_run_sweep_writes_the_reference_schema_and_resumes(tmp_path,
                                                           monkeypatch):
    first, path = _tiny(tmp_path, monkeypatch, tune="model")
    assert (first["n_measured"], first["n_skipped"]) == (4, 0)
    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == rsweep.SCHEMA_VERSION
    # the reference's point schema, built by its own model_point on the
    # same plan, with the reference's measured and bookkeeping keys
    point = raw["points"][next(iter(raw["points"]))]
    rspec = rst.SPECS[point["stencil"]]
    from repro.core.mwd import MWDPlan as RPlan
    rmodel = rsweep.model_point(rspec, tuple(point["grid"]), 2,
                                RPlan(**point["plan"]), 1, 4)
    want = dict(rmodel, key="", stencil="", op_fingerprint="", grid=[],
                n_steps=0, mode="", batch=0, word_bytes=0, dtype="",
                distributed=False, plan={}, plan_source="",
                measured={"t_s": 0.0, "glups": 0.0}, spec="",
                hw_fingerprint="")
    got_schema, want_schema = _schema(point), _schema(want)
    # the reference's ECM names its shared-memory term t_vmem; the port's
    # t_smem (the H100's), and the port adds the K1 model and the card
    want_schema["model.ecm.t_smem"] = want_schema.pop("model.ecm.t_vmem")
    for k, t in want_schema.items():
        assert k in got_schema, k
        assert got_schema[k] == t or {got_schema[k], t} <= {"int", "float"},\
            (k, got_schema[k], t)
    assert point["device"] == {"name": "cpu", "power_limit": None}
    assert point["plan_source"] == "tuned:model"
    assert "k1_t_s" not in point["measured"]       # no card: no K1 event
    assert point["model"]["k1"]["phases"].keys() == {"cluster", "cta",
                                                     "row_loads"}
    # the ECM calibration was fitted and saved beside the results
    calib = os.path.join(os.path.dirname(path), "ecm-h100-sxm.json")
    assert first["calibration_path"] == calib and os.path.exists(calib)
    # a second run resumes everything: nothing measured
    again, _ = _tiny(tmp_path, monkeypatch)
    assert (again["n_measured"], again["n_skipped"]) == (0, 4)


def test_sweep_cli_expect_cached_and_stale_points(tmp_path, monkeypatch):
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "plans.json"))
    path = str(tmp_path / "sweep-cli.json")
    argv = ["--device", "cpu", "--stencil", "7pt-const", "--grid", "6,10,8",
            "--steps", "2", "--reps", "1", "--results", path]
    first = tsweep.main(argv)
    assert first["n_measured"] == 1
    assert tsweep.main(argv + ["--expect-cached"])["n_measured"] == 0
    # a point measured under another hardware fingerprint is stale
    with open(path) as f:
        raw = json.load(f)
    for p in raw["points"].values():
        p["hw_fingerprint"] = "elsewhere"
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.raises(SystemExit, match="expect-cached"):
        tsweep.main(argv + ["--expect-cached"])
    # a sibling sweep*.json counts as done
    other = str(tmp_path / "sweep-other.json")
    assert tsweep.main(argv[:-1] + [other])["n_measured"] == 0


@pytest.mark.parametrize("flag", ["--distributed", "--scaling"])
def test_distributed_and_scaling_refuse(flag, capsys):
    with pytest.raises(SystemExit) as e:
        tsweep.main(["--device", "cpu", flag])
    assert e.value.code != 0
    assert "ROADMAP.md item 11" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 11"):
        tsweep.run_sweep([tst.SPECS["7pt-const"]], [(6, 10, 8)],
                         distributed=True, device="cpu")


def test_smoke_profile_equals_reference_less_its_distributed_point():
    got = tsweep.smoke_profile()
    want = rsweep.smoke_profile()
    assert [s.name for s in got["specs"]] == [s.name for s in want["specs"]]
    assert {k: v for k, v in got.items() if k != "specs"} == \
        {k: v for k, v in want.items() if k != "specs"}
    got_keys = [p.key for p in tsweep._smoke_points(4)]
    want_keys = [p.key for p in rsweep._smoke_points(4)
                 if not p.distributed]
    assert got_keys == want_keys
    # the smoke file never lands among the committed results
    assert os.path.dirname(tsweep.SMOKE_RESULTS) != tsweep.RESULTS_DIR


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dt", ["f32", "f64", "bf16"])
def test_random_problem_has_make_problems_layout(name, dt):
    """The timing problems: `make_problem`'s shapes, dtypes, packing and
    scalars, standard-normal draws (array streams scaled), one seed one
    problem; not the reference's numbers."""
    import torch
    from repro_torch.core import ir as tir
    _, spec = pair(name)
    shape = (10, 12, 14)
    got = tst.random_problem(spec, shape, dtype=dt, seed=3, device="cpu")
    want = tst.make_problem(spec, shape, dtype=dt, seed=3, device="cpu")
    again = tst.random_problem(spec, shape, dtype=dt, seed=3, device="cpu")
    for a, b, c in zip(got[0], want[0], again[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, c)
    assert (got[0][0] is got[0][1]) == (want[0][0] is want[0][1])
    ga, gs = tir.split_coeffs(spec, got[1])
    wa, ws = tir.split_coeffs(spec, want[1])
    assert gs == ws
    assert (ga is None) == (wa is None)
    if ga is not None:
        assert ga.shape == wa.shape and ga.dtype == wa.dtype
        assert float(ga.double().std()) == pytest.approx(
            spec.coeff_scale, rel=0.25)
    assert float(got[0][0].double().std()) == pytest.approx(1.0, rel=0.25)
    assert not torch.equal(got[0][0], tst.random_problem(
        spec, shape, dtype=dt, seed=4, device="cpu")[0][0])
