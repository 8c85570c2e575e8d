"""The port's optimizer, fit step and `launch.fit` against the reference's.

`repro_torch.optim.optimizers` (AdamW, warmup-cosine, global-norm clipping)
is held against `repro.optim.optimizers` on the same arrays; the fit
(`repro_torch.launch.fit`, through `ops.mwd_diff` on CPU tensors) against
`repro.launch.fit` at 7pt-var (8, 12, 10), 2 steps, 2 windows, seed 0: the
first 5 losses, and one step continued from the reference's own fit state
carried across by `fit_state_from_numpy`. The reference's fit runs its
Pallas kernel in interpret mode, as its own tests do.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stencils as rst
from repro.launch import fit as rfit
from repro.optim import optimizers as ropt
from repro_torch.core import stencils as tst
from repro_torch.launch import fit as tfit
from repro_torch.optim import optimizers as topt

FIT = dict(n_steps=2, windows=2, seed=0)
GRID = (8, 12, 10)
# float32 arithmetic in a different order (XLA's and torch's reductions,
# pow and cos) moves the last bits; the fit's numbers agree far closer
RTOL = 1e-5


def tensor(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("warmup,total", [(10, 200), (0, 40), (3, 5)])
def test_warmup_cosine_equals_reference(warmup, total):
    ref = ropt.warmup_cosine(3e-2, warmup=warmup, total=total)
    port = topt.warmup_cosine(3e-2, warmup=warmup, total=total)
    for step in range(0, total + 3):
        got, want = float(port(step)), float(ref(step))
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_clip_by_global_norm_equals_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        want, wn = ropt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        got, gn = topt.clip_by_global_norm(
            {k: tensor(v) for k, v in tree.items()}, max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_adamw_equals_reference(dtype):
    """Three updates of a two-leaf tree: updates, moments, parameters."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((3, 4)).astype(dtype),
              "b": rng.standard_normal(5).astype(dtype)}
    lr = ropt.warmup_cosine(1e-2, warmup=2, total=10)
    ropt_ = ropt.adamw(lr=lr)
    topt_ = topt.adamw(lr=topt.warmup_cosine(1e-2, warmup=2, total=10))
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: tensor(v) for k, v in params.items()}
    rs, ts = ropt_.init(rp), topt_.init(tp)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(dtype)
                 for k, v in params.items()}
        ru, rs = ropt_.update({k: jnp.asarray(v) for k, v in grads.items()},
                              rs, rp, step)
        tu, ts = topt_.update({k: tensor(v) for k, v in grads.items()}, ts,
                              tp, torch.tensor(step, dtype=torch.int32))
        rp, tp = ropt.apply_updates(rp, ru), topt.apply_updates(tp, tu)
        tol = 1e-6 if dtype == np.float32 else 1e-3
        for k in params:
            assert tu[k].dtype == tp[k].dtype == tensor(params[k]).dtype
            for got, want in ((tu[k], ru[k]), (ts["m"][k], rs["m"][k]),
                              (ts["v"][k], rs["v"][k]), (tp[k], rp[k])):
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=tol, atol=tol * 1e-2)


@pytest.fixture(scope="module")
def reference_fit():
    """The reference's 5-step fit: loss0, the per-step metrics, the state
    after 4 steps (as numpy) and after 5."""
    op = rst.SPECS["7pt-var"]
    state, fit_step, loss_fn, _ = rfit.build_fit(op, GRID, max_steps=5,
                                                 **FIT)
    loss0 = float(loss_fn(state["params"])[0])
    metrics, states = [], []
    for _ in range(5):
        states.append(jax.device_get(state))
        state, m = fit_step(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"loss0": loss0, "metrics": metrics, "state4": states[4],
            "state5": jax.device_get(state)}


def test_first_losses_match_reference(reference_fit):
    rep = tfit.run_fit(tst.SPECS["7pt-var"], GRID, max_steps=5,
                       telemetry="", device="cpu", **FIT)
    assert rep["loss0"] == pytest.approx(reference_fit["loss0"], rel=RTOL)
    for got, want in zip(rep["trace"], reference_fit["metrics"]):
        for k in ("loss", "grad_norm", "coeff_rmse"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), (got, want)
    # the metric is the loss before the update
    assert rep["trace"][0]["loss"] == pytest.approx(rep["loss0"], rel=1e-6)
    losses = [r["loss"] for r in rep["trace"]]
    assert losses == sorted(losses, reverse=True)


def test_reference_state_continues_one_step_in_the_port(reference_fit):
    """The reference's state after 4 steps, carried across, takes the 5th
    step in the port as in the reference."""
    carried = tfit.fit_state_from_numpy(reference_fit["state4"],
                                        device="cpu")
    ref4 = reference_fit["state4"]
    assert np.array_equal(carried["params"].numpy(), ref4["params"])
    assert np.array_equal(carried["opt"]["m"].numpy(), ref4["opt"]["m"])
    assert int(carried["step"]) == 4
    _, fit_step, _, _ = tfit.build_fit(tst.SPECS["7pt-var"], GRID,
                                       max_steps=5, device="cpu", **FIT)
    state, metrics = fit_step(carried)
    want = reference_fit["metrics"][4]
    for k in ("loss", "grad_norm", "coeff_rmse"):
        assert float(metrics[k]) == pytest.approx(want[k], rel=RTOL)
    ref5 = reference_fit["state5"]
    assert int(state["step"]) == 5
    for got, exp in ((state["params"], ref5["params"]),
                     (state["opt"]["m"], ref5["opt"]["m"]),
                     (state["opt"]["v"], ref5["opt"]["v"])):
        np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4, atol=1e-9)


def test_fit_gate_on_the_port():
    """The reference's CI gate: 40 steps cut the loss at least 10x."""
    rep = tfit.run_fit(tst.SPECS["7pt-var"], GRID, max_steps=40,
                       telemetry="", device="cpu", **FIT)
    assert rep["steps"] == 40 and rep["reduction"] >= 10.0, rep["reduction"]
    assert all(np.isfinite(r["loss"]) for r in rep["trace"])


def test_build_fit_refuses_an_op_without_streams():
    with pytest.raises(ValueError, match="nothing to fit"):
        rfit.build_fit(rst.SPECS["7pt-const"], GRID)
    with pytest.raises(ValueError, match="nothing to fit"):
        tfit.build_fit(tst.SPECS["7pt-const"], GRID, device="cpu")


def test_main_gate_and_trace(tmp_path, capsys):
    out = tmp_path / "trace.json"
    rep = tfit.main(["--device", "cpu", "--grid", "8,12,10", "--max-steps",
                     "40", "--gate", "10", "--telemetry", "", "--out",
                     str(out)])
    assert rep["reduction"] >= 10.0
    saved = json.loads(out.read_text())
    assert saved["steps"] == 40 and len(saved["trace"]) == 40
    assert saved["loss"] == rep["loss"]
    assert "fit[7pt-var]" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        tfit.main(["--device", "cpu", "--grid", "8,12,10", "--max-steps",
                   "2", "--gate", "1000", "--telemetry", ""])
    assert exc.value.code == 4
    assert "gate FAILED" in capsys.readouterr().out


def test_fit_runs_on_the_25_point_op(tmp_path):
    """A 2nd-order op with an array scale: the loss falls."""
    rep = tfit.run_fit(tst.SPECS["25pt-const"], (14, 20, 16), max_steps=4,
                       warmup=1, telemetry=f"jsonl:{tmp_path / 'f.jsonl'}",
                       log_every=2, device="cpu", **FIT)
    assert rep["loss"] < rep["loss0"]
    lines = (tmp_path / "f.jsonl").read_text().splitlines()
    assert len(lines) == 2


def test_fit_modules_import_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.kernels.adjoint, repro_torch.optim\n"
            "import repro_torch.training.steps, repro_torch.launch.fit\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "print(bad)\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
