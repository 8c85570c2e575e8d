"""The port's benchmark harness (`repro_torch.benchmarks.run`) on the CPU,
against the reference's `benchmarks/run.py`.

Every bench runs at the reference's sizes on the plain versions, and its
gates must hold. Row names pair with the reference's row for row (the
port adds the methods the reference's docstring names for Figs. 8-15);
the fields both harnesses compute from the same closed forms (Eq. 3/5,
the bytes and launches of the reference's schedule, the custom op's
analytics) are equal. The reference's benches run in-process with its
wall-clock helper `_t` stubbed out, since their timings are not compared;
adjoint_fit and batched_serving, which time outside `_t`, are named from
the reference's loops instead.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest

import benchmarks.run as rbench
from repro_torch.benchmarks import run as tbench
from repro_torch.core import ir as tir
from repro_torch.launch import tune as ttune

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# the reference's rows for the two benches not run here (benchmarks/run.py
# adjoint_fit and batched_serving loops)
NAMED = {
    "adjoint_fit": ["adjoint.7pt-var", "adjoint.25pt-const",
                    "adjoint.fit.7pt-var"],
    "batched_serving": ["batched.7pt-const.B4", "batched.7pt-var.B4"],
}
# rows the port adds: spatial (K2), ghost-zone (K3) and plan="auto" beside
# the reference's naive and MWD rows
ADDED = {"fig8_15_perf": {f"perf.{op}.{m}.{n}" for op in rbench.st.SPECS
                          for m in ("spatial", "ghostzone", "auto")
                          for n in (48, 64)}}
# fields computed by the same closed forms in both harnesses
SHARED = {
    "fig4_code_balance": ("block_KiB", "Bc_model", "Bc_kernel"),
    "fig19_energy": ("Bc",),
    "fused_vs_row": ("hbm_MB", "launches", "hbm_saved"),
    "smoke": ("fused_MB", "row_MB", "launches"),
    "custom_stencil": ("flops", "streams", "fingerprint", "fused_MB",
                       "row_MB"),
}


def fields(derived: str) -> dict:
    # lm_substrate's rows start with a bare tag ("reduced_cfg_2L_d64")
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


def parse(text: str) -> dict:
    rows = {}
    for line in text.strip().splitlines():
        name, _us, derived = line.split(",", 2)
        rows[name] = fields(derived)
    return rows


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A scratch plan registry and soak report for both harnesses."""
    tmp = tmp_path_factory.mktemp("bench")
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TORCH_PLAN_REGISTRY", str(tmp / "torch_plans.json"))
    mp.setenv("REPRO_PLAN_REGISTRY", str(tmp / "plans.json"))
    mp.setenv("REPRO_TORCH_SOAK_REPORT", str(tmp / "soak.json"))
    yield tmp
    mp.undo()


@pytest.fixture(scope="module")
def port(env):
    """Every bench of the port on the CPU: its rows, or what it raised."""
    out = {}
    for name, fn in tbench.BENCHES.items():
        b = tbench.Bench("cpu", echo=False)
        try:
            fn(b)
            out[name] = b.rows
        except Exception as e:          # reported by the bench's own test
            out[name] = e
    return out


@pytest.fixture(scope="module")
def reference(env):
    """The reference's rows, its timing helper stubbed."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rbench, "_t", lambda *a, **k: 1.0)
    out = {}
    try:
        for name, fn in rbench.BENCHES.items():
            if name in NAMED or name == "soak":
                continue
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn()
            out[name] = parse(buf.getvalue())
    finally:
        mp.undo()
    return out


def test_benches_are_the_references_but_the_lm_substrate():
    # the name predates the LM substrate's port: the lists are now equal
    assert list(tbench.BENCHES) == list(rbench.BENCHES)


@pytest.mark.parametrize("name", list(tbench.BENCHES))
def test_bench_runs_on_the_cpu_and_its_gates_hold(port, name):
    rows = port[name]
    if isinstance(rows, Exception):
        raise rows
    assert rows and all(r.derived.endswith(";device=cpu") for r in rows)
    assert len({r.name for r in rows}) == len(rows)


@pytest.mark.parametrize("name", [k for k in tbench.BENCHES
                                  if k != "soak"])
def test_row_names_pair_with_the_references(port, reference, name):
    if isinstance(port[name], Exception):
        raise port[name]
    got = {r.name for r in port[name]}
    want = set(NAMED.get(name) or reference[name])
    assert got == want | ADDED.get(name, set())


@pytest.mark.parametrize("name", list(SHARED))
def test_shared_fields_equal_the_references(port, reference, name):
    if isinstance(port[name], Exception):
        raise port[name]
    rows = {r.name: fields(r.derived) for r in port[name]}
    for row, want in reference[name].items():
        for key in SHARED[name]:
            if key in want:
                assert rows[row][key] == want[key], (row, key)


def test_tpu_fields_are_renamed(port):
    text = "\n".join(r.derived for rows in port.values()
                     if not isinstance(rows, Exception) for r in rows)
    for gone in ("v5e", "cpu_GLUPs", "vmem"):
        assert gone not in text
    perf = {r.name: fields(r.derived) for r in port["fig8_15_perf"]}
    assert "h100_model_GLUPs" in perf["perf.7pt-const.mwd.48"]
    assert "GLUPs" in perf["perf.7pt-const.naive.48"]


def test_groupsize_rows_follow_the_fit_twin(port):
    """The model leg: the reference's cluster ladder on the CPU, each size
    priced only where the twin finds rings that fit."""
    rows = [r for r in port["fig16_18_groupsize"]]
    assert [r.data["cluster"] for r in rows] == [1, 2, 4, 8, 16] * 2
    for r in rows:
        f = fields(r.derived)
        assert (f["smem_fits"] == "True") == r.data["fits"]
        assert (f["model_ms"] == "-") == (not r.data["fits"])
    assert any(r.data["fits"] for r in rows[:5])
    assert any(r.data["fits"] for r in rows[5:])


def test_custom_box_resolves_by_path():
    op = tir.resolve_op("repro_torch.benchmarks.run:CUSTOM_BOX")
    assert op is tbench.CUSTOM_BOX
    assert op.fingerprint == rbench.CUSTOM_BOX.fingerprint
    assert (op.flops_per_lup, op.n_streams) == (
        rbench.CUSTOM_BOX.flops_per_lup, rbench.CUSTOM_BOX.n_streams)


def test_custom_box_tunes_then_hits_the_cache(tmp_path, capsys):
    args = ["--device", "cpu", "--stencil",
            "repro_torch.benchmarks.run:CUSTOM_BOX", "--grid", "8,14,12",
            "--max-evals", "4", "--reps", "1", "--steps", "2",
            "--registry", str(tmp_path / "plans.json")]
    first = ttune.main(args)
    assert [r["source"] for r in first] == ["measured"]
    assert first[0]["measurements"] > 0
    again = ttune.main(args + ["--expect-cached"])
    assert [(r["source"], r["measurements"]) for r in again] == [
        ("cached", 0)]
    assert again[0]["plan"] == first[0]["plan"]


def test_cli_prints_the_references_header(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "smoke",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC,
             "REPRO_TORCH_PLAN_REGISTRY": str(tmp_path / "plans.json")})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "smoke.7pt-const", "smoke.25pt-const", "smoke.autotune"]
