"""End-to-end driver: 3-D heat diffusion for hundreds of steps through K1,
with checkpoint and restart.

The paper's kind of end-to-end workload, an iterative stencil run (state,
step, checkpoints: the analog of a training loop). Each span of steps is
one `ops.mwd` call at an explicit ``MWDPlan(d_w)``, so K1 runs on the card
(its plain version on the CPU). The run checkpoints every ``--ckpt-every``
steps through `distributed.checkpoint.AsyncCheckpointer`; ``--resume``
continues from the newest committed checkpoint, bit-identical to an
uninterrupted run, and ``--verify`` asserts that the result equals a
straight-through `ops.naive` run bit for bit.

  python -m repro_torch.examples.heat3d_train --steps 240 --verify
  python -m repro_torch.examples.heat3d_train --steps 240 --resume
  python -m repro_torch.examples.heat3d_train --device cpu --n 32 \\
      --steps 96 --verify

The port of ``examples/heat3d_train.py``: 64^3 on the CPU, 256^3 on the
card unless ``--n`` says otherwise. Checkpoints go under the temporary
directory unless ``--ckpt`` names one.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import stencils as st
from repro_torch.core.mwd import MWDPlan
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint
from repro_torch.kernels import ops

KAPPA = 0.1


def initial_state(n: int, device) -> torch.Tensor:
    """The reference's seeded initial field (numpy, seed 3), float32."""
    rng = np.random.default_rng(3)
    u0 = rng.standard_normal((n, n, n)).astype(np.float32)
    return torch.from_numpy(u0).to(device)


def heat_coeffs() -> tuple[float, float]:
    """Stable explicit Euler: c0 = 1 - 6k, c1 = k, rounded to float32."""
    return tuple(float(np.float32(c)) for c in (1 - 6 * KAPPA, KAPPA))


def main(argv=None) -> dict:
    """Run (or resume) the diffusion; returns the final state and counts."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "heat3d_train")
    ap.add_argument("--n", type=int, default=None,
                    help="grid edge (default 64 on the CPU, 256 on the card)")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--span", type=int, default=24,
                    help="steps per ops.mwd call")
    ap.add_argument("--dw", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_heat3d_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=48)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n or (256 if dev.type == "cuda" else 64)

    spec = st.SPECS["7pt-const"]
    coeffs = heat_coeffs()
    u0 = initial_state(n, dev)
    state = (u0, u0)

    start = 0
    if args.resume and checkpoint.latest_step(args.ckpt) is not None:
        start, restored = checkpoint.restore(args.ckpt,
                                             {"cur": u0, "prev": u0})
        state = (restored["cur"], restored["prev"])
        print(f"resumed at step {start}")
    elif os.path.isdir(args.ckpt) and not args.resume:
        shutil.rmtree(args.ckpt, ignore_errors=True)

    ck = checkpoint.AsyncCheckpointer(args.ckpt)
    plan = MWDPlan(d_w=args.dw)
    lups = 0
    t0 = time.perf_counter()
    step = start
    while step < args.steps:
        span = min(args.span, args.steps - step,
                   args.ckpt_every - step % args.ckpt_every)
        state = ops.mwd(spec, state, coeffs, span, plan=plan)
        step += span
        lups += span * n ** 3
        if step % args.ckpt_every == 0 or step == args.steps:
            ck.save(step, {"cur": state[0], "prev": state[1]})
            print(f"step {step:5d}  mean={float(state[0].mean()):+.6f} "
                  f"max={float(state[0].abs().max()):.4f}  [checkpointed]")
    ck.wait_pending()
    dt = time.perf_counter() - t0
    print(f"{args.steps - start} steps of {n}^3 in {dt:.1f}s "
          f"({lups / dt / 1e6:.1f} MLUP/s host clock, checkpoints included, "
          f"on {dev})")

    report = {"state": state, "start": start, "steps": args.steps,
              "seconds": dt}
    if args.verify:
        ref = ops.naive(spec, (u0, u0), coeffs, args.steps)
        err = float((ref[0].double() - state[0].double()).abs().max())
        bitwise = torch.equal(ref[0], state[0]) and torch.equal(ref[1],
                                                                state[1])
        print(f"verify vs naive straight-through: max|err| = {err:.2e}, "
              f"bitwise {bitwise}")
        if not bitwise:
            raise RuntimeError("the checkpointed run differs from a "
                               f"straight-through naive run ({err:.2e})")
        print("verified.")
        report["bitwise"] = bitwise
    return report


if __name__ == "__main__":
    main()
