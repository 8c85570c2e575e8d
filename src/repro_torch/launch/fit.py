"""Coefficient-field fitting through the differentiable MWD launch.

The port of `repro.launch.fit`: recover a stencil's per-cell coefficient
streams from observed forward trajectories by gradient descent through
K1. Every optimization step runs one MWD advance per observation window
forward and one adjoint advance backward (`kernels.adjoint`), with plans
resolved registry-first like any served workload (the gradient launches
under the ``vjp`` variant key).

Problem setup (seeded, the reference's numbers for a seed): truth
coefficients from `ir.make_problem`, observations from the forward launch
on `--windows` independent initial states, initial guess = truth + a
`--perturb`-scaled noise field drawn by ``np.random.default_rng(seed +
7)``. The loss is the interior MSE between the predicted and observed
final levels, averaged over windows; each step is
`training.steps.make_fit_step` (AdamW + warmup-cosine).

  python -m repro_torch.launch.fit                           # on the card
  python -m repro_torch.launch.fit --device cpu --grid 8,12,10 --max-steps 5
  python -m repro_torch.launch.fit --gate 10 --max-steps 40 --out trace.json

`--gate R` turns the run into a pass/fail check: the final loss must sit
at least R times below the initial loss within `--max-steps` optimization
steps (exit code 4 otherwise). `--out` writes the full fit trace as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core import specs as devspecs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.telemetry import make_telemetry
from repro_torch.optim import optimizers
from repro_torch.training.steps import make_fit_step


def build_fit(op: ir.StencilOp, grid, *, n_steps: int = 2, windows: int = 2,
              seed: int = 0, perturb: float = 1.0, lr: float = 3e-2,
              warmup: int = 10, max_steps: int = 200, clip: float = 1.0,
              dtype=None, plan=None, device="cuda",
              device_draws: bool = False):
    """Assemble one seeded coefficient-fit problem on `device`.

    Returns ``(state, fit_step, loss_fn, truth)``: the initial train state
    (perturbed coefficients and optimizer state), the step, the bare loss
    closure (for the step-0 readout) and the truth streams. Only per-cell
    coefficient streams are recoverable (scalars are compile-time
    constants of the launch), so `op` must have array slots.
    `device_draws` draws the same distributions on the device
    (`ir.random_problem`, torch's generator): not the reference's numbers,
    but seconds instead of minutes at production sizes.
    """
    if not op.n_coeff_arrays:
        raise ValueError(
            f"{op.name}: nothing to fit — the op has no per-cell coefficient "
            "streams (compile-time scalars are static, not differentiable)")
    dev = resolve_device(device)
    draw = ir.random_problem if device_draws else ir.make_problem
    _, coeffs_true = draw(op, grid, seed=seed, device=dev)
    truth, scalars = ir.split_coeffs(op, coeffs_true)
    scalars = tuple(float(x) for x in scalars)
    states = [draw(op, grid, seed=seed + 101 + j, device=dev)[0]
              for j in range(windows)]
    obs = [ops.mwd(op, s, ir.join_coeffs(op, truth, scalars), n_steps,
                   plan=plan, dtype=dtype)
           for s in states]
    r = op.radius

    def loss_fn(params):
        total = 0.0
        for s, o in zip(states, obs):
            pred = ops.mwd_diff(op, s, ir.join_coeffs(op, params, scalars),
                                n_steps, plan=plan, dtype=dtype)
            d = (pred[0] - o[0])[..., r:-r, r:-r, r:-r]
            total = total + torch.mean(torch.square(d.float()))
        rmse = torch.sqrt(torch.mean(torch.square(params - truth)))
        return total / len(states), {"coeff_rmse": rmse}

    if device_draws:
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        noise = torch.randn(truth.shape, generator=gen, device=dev).to(
            truth.dtype)
    else:
        rng = np.random.default_rng(seed + 7)
        noise = ir.from_f64(rng.standard_normal(tuple(truth.shape)),
                            truth.dtype, dev)
    params0 = truth + perturb * op.coeff_scale * noise

    opt = optimizers.adamw(
        lr=optimizers.warmup_cosine(lr, warmup=warmup, total=max_steps))
    state = {"params": params0, "opt": opt.init(params0),
             "step": torch.tensor(0, dtype=torch.int32)}
    return state, make_fit_step(opt, loss_fn, clip=clip), loss_fn, truth


def fit_state_from_numpy(state, device="cuda") -> dict:
    """A fit state given as numpy (the reference's ``{"params", "opt":
    {"m", "v"}, "step"}``, e.g. through ``jax.device_get``) as the port's
    tensors on `device`, every value kept bit for bit."""
    dev = resolve_device(device)
    tensor = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return {"params": optimizers.tree_map(tensor, state["params"]),
            "opt": optimizers.tree_map(tensor, state["opt"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32)}


def run_fit(op: ir.StencilOp, grid, *, max_steps: int = 200,
            log_every: int = 10, telemetry=None, **kw) -> dict:
    """Drive the fit to `max_steps` and return the trace report."""
    tele = make_telemetry(telemetry)
    state, fit_step, loss_fn, _ = build_fit(op, grid, max_steps=max_steps,
                                            **kw)
    with torch.no_grad():
        loss0 = float(loss_fn(state["params"])[0])
    trace, t0 = [], time.perf_counter()
    loss = loss0
    for i in range(max_steps):
        state, metrics = fit_step(state)
        loss = float(metrics["loss"])
        rec = {"step": i + 1, "loss": loss,
               "grad_norm": float(metrics["grad_norm"]),
               "coeff_rmse": float(metrics["coeff_rmse"])}
        trace.append(rec)
        if (i + 1) % log_every == 0 or i + 1 == max_steps:
            tele.emit("fit", stencil=op.name, **rec)
    tele.close()
    return {"stencil": op.name, "grid": list(grid), "loss0": loss0,
            "loss": loss, "reduction": loss0 / max(loss, 1e-30),
            "steps": len(trace), "seconds": time.perf_counter() - t0,
            "trace": trace}


def main(argv=None) -> dict:
    """CLI entry point; returns the fit report (tested directly)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fit",
        description="Fit per-cell stencil coefficients through the "
                    "differentiable MWD launch")
    ap.add_argument("--stencil", default="7pt-var",
                    help="op to fit (needs per-cell coefficient streams): "
                         "paper op, registered name, or module.path:ATTR")
    ap.add_argument("--grid", type=str, default=None,
                    help="Z,Y,X grid (default: per-stencil sanity scale)")
    ap.add_argument("--steps", type=int, default=2,
                    help="stencil time steps per observation window")
    ap.add_argument("--windows", type=int, default=2,
                    help="independent observation trajectories")
    ap.add_argument("--max-steps", type=int, default=200,
                    help="optimization step budget")
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--perturb", type=float, default=1.0,
                    help="initial-guess noise, in units of the op's "
                         "coefficient scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", type=str, default=None,
                    help="stream dtype for the forward/adjoint launches")
    ap.add_argument("--plan", type=str, default=None,
                    help="'auto' resolves forward plans registry-first and "
                         "gradient plans under the vjp variant key")
    ap.add_argument("--gate", type=float, default=0.0,
                    help="require loss0/loss >= GATE (exit 4 otherwise)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry", type=str, default="stdout",
                    help="'stdout', 'jsonl:<path>', or '' for none")
    ap.add_argument("--out", type=str, default=None,
                    help="write the full fit trace as JSON here")
    ap.add_argument("--spec", type=str, default=None,
                    help="device spec name/path for plan resolution")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    if args.spec:
        devspecs.set_default_spec(args.spec)
    op = ir.resolve_op(args.stencil)
    from repro_torch.core import registry as reg
    grid = (tuple(int(x) for x in args.grid.split(",")) if args.grid
            else reg.default_grid(op))

    report = run_fit(op, grid, n_steps=args.steps, windows=args.windows,
                     seed=args.seed, perturb=args.perturb, lr=args.lr,
                     warmup=args.warmup, clip=args.clip, dtype=args.dtype,
                     plan=args.plan, max_steps=args.max_steps,
                     log_every=args.log_every, telemetry=args.telemetry,
                     device=args.device)
    print(f"fit[{op.name}] grid={grid} loss {report['loss0']:.4e} -> "
          f"{report['loss']:.4e} ({report['reduction']:.1f}x) in "
          f"{report['steps']} steps, {report['seconds']:.1f}s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    if args.gate and report["reduction"] < args.gate:
        print(f"gate FAILED: {report['reduction']:.2f}x < {args.gate}x")
        raise SystemExit(4)
    return report


if __name__ == "__main__":
    main()
