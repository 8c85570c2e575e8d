"""Quickstart: the paper's technique on the port in one script.

Runs the four corner-case stencils through naive, spatial (K2), ghost-zone
(K3) and MWD (K1, at a fixed plan and at ``plan="auto"``) and the MWD
executor `run_mwd`, checks that they agree with naive, and prints each
op's code balance under spatial blocking and under MWD, the quantity the
paper is about.

  python -m repro_torch.examples.quickstart                 # on the card
  python -m repro_torch.examples.quickstart --device cpu    # plain versions

The port of ``examples/quickstart.py``: on the CPU at its grid (24 x 32 x
40), on the card at 256^3 (drawn there, `stencils.random_problem`).
"""

from __future__ import annotations

import argparse

from repro_torch.core import models
from repro_torch.core import stencils as st
from repro_torch.core.mwd import MWDPlan, run_mwd
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

CPU_GRID = (24, 32, 40)
CARD_GRID = (256, 256, 256)
STEPS = 4
TOLERANCE = 1e-3                # the reference's agreement bound


def mwd_width(spec) -> int:
    return 8 if spec.radius == 1 else 16


def run_methods(spec, state, coeffs, n_steps: int = STEPS) -> dict:
    """Every method's ``(cur, prev)`` for one problem, naive first."""
    d_w = mwd_width(spec)
    return {
        "naive": ops.naive(spec, state, coeffs, n_steps),
        "spatial-kernel": ops.spatial(spec, state, coeffs, n_steps, bz=4),
        "ghostzone-kernel": ops.ghostzone(spec, state, coeffs, n_steps,
                                          t_block=2, bz=8, by=8),
        "mwd-kernel": ops.mwd(spec, state, coeffs, n_steps, d_w=d_w, n_f=2),
        # registry-first (python -m repro_torch.launch.tune persists a
        # measured plan), the model-scored tuner on a miss
        "mwd-auto": ops.mwd(spec, state, coeffs, n_steps, plan="auto"),
        "mwd-executor": run_mwd(spec, state, coeffs, n_steps,
                                MWDPlan(d_w=d_w)),
    }


def main(argv=None) -> dict:
    """Run every op; returns ``{op: {method: max|err| vs naive}}``."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    grid = CARD_GRID if dev.type == "cuda" else CPU_GRID
    draw = st.random_problem if dev.type == "cuda" else st.make_problem
    report = {}
    for name, spec in st.SPECS.items():
        state, coeffs = draw(spec, grid, seed=0, device=dev)
        outs = run_methods(spec, state, coeffs)
        ref = outs.pop("naive")
        errs = {k: float((v[0].double() - ref[0].double()).abs().max())
                for k, v in outs.items()}
        d_w = mwd_width(spec)
        bc_spatial = models.spatial_code_balance(spec, 4)
        bc_mwd = models.code_balance(spec, d_w, 4)
        print(f"{name:11s} max|err| vs naive: "
              + "  ".join(f"{k}={v:.1e}" for k, v in errs.items()))
        print(f"{'':11s} code balance: spatial {bc_spatial:5.1f} B/LUP -> "
              f"MWD(D_w={d_w}) {bc_mwd:5.2f} B/LUP "
              f"({bc_spatial / bc_mwd:.1f}x less HBM traffic)")
        if not all(e < TOLERANCE for e in errs.values()):
            raise RuntimeError(f"{name}: a method disagrees with naive: "
                               f"{errs}")
        report[name] = errs
    print(f"\nall methods agree on {dev} at {'x'.join(map(str, grid))}; "
          "python -m repro_torch.benchmarks.run runs the paper's figures")
    return report


if __name__ == "__main__":
    main()
