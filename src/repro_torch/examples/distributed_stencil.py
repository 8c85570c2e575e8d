"""A stencil run over 8 shards with deep halos, then an elastic restart.

Runs 7pt-var on a (2, 2, 2) pod/data/model mesh of 8 shards with deep-halo
super-steps (K1 per shard at ``plan="auto"``, the overlapped schedule where
the shards have room), checkpoints, then reshards the checkpoint onto a
(2, 2) mesh (one "pod" lost) and finishes there, the elastic path. The
result must equal a single-device `ops.naive` run bit for bit.

  python -m repro_torch.examples.distributed_stencil               # card
  python -m repro_torch.examples.distributed_stencil --device cpu

The port of ``examples/distributed_stencil.py``. One process holds every
shard, and a mesh may repeat a device: the 8 shards are ``[cuda:0] * 8``
on one card (``[cpu] * 8`` on the CPU), so this shows the decomposition
and the restart, not a speed-up. 16 x 16 x 32 on the CPU (the reference's
grid), 256^3 on the card.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.core import stencils as st
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint, stepper
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh

CPU_GRID = (16, 16, 32)
CARD_GRID = (256, 256, 256)
T1, T2, T_BLOCK = 4, 4, 2


def run(spec, state, coeffs, device, ckpt_dir: str):
    """Phase 1 on 8 shards, a checkpoint, phase 2 on 4: ``(cur, prev)``."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     devices=[device] * 8)
    out = stepper.run_distributed(spec, mesh, state, coeffs, T1,
                                  t_block=T_BLOCK, plan="auto",
                                  overlap="auto")
    checkpoint.save(ckpt_dir, T1, {"cur": out[0], "prev": out[1]})
    print(f"phase 1: {T1} steps on {mesh.devices.size} shards, checkpointed")

    small = make_mesh((2, 2), ("data", "model"), devices=[device] * 4)
    _, restored = checkpoint.restore(
        ckpt_dir, {"cur": out[0], "prev": out[1]},
        placement_fn=lambda name, leaf: small.devices.flat[0])
    out2 = stepper.run_distributed(spec, small, (restored["cur"],
                                                 restored["prev"]),
                                   coeffs, T2, t_block=T_BLOCK, plan="auto")
    print(f"phase 2: {T2} more steps on the degraded "
          f"{small.devices.size}-shard mesh")
    return out2


def main(argv=None) -> dict:
    """Returns the final levels, naive's, and their difference."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "distributed_stencil")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    spec = st.SPECS["7pt-var"]
    grid = CARD_GRID if dev.type == "cuda" else CPU_GRID
    draw = st.random_problem if dev.type == "cuda" else st.make_problem
    state, coeffs = draw(spec, grid, seed=11, device=dev)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="repro_torch_dist_")
    try:
        out = run(spec, state, coeffs, dev, ckpt_dir)
    finally:
        if args.ckpt is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    ref = ops.naive(spec, state, coeffs, T1 + T2)
    err = float((ref[0].double() - out[0].double()).abs().max())
    bitwise = torch.equal(ref[0], out[0]) and torch.equal(ref[1], out[1])
    print(f"elastic-restart result vs naive: max|err| = {err:.2e}, "
          f"bitwise {bitwise}")
    if not bitwise:
        raise RuntimeError(f"the resharded run differs from naive ({err})")
    print("verified: pod loss -> reshard -> continue is exact.")
    return {"out": out, "naive": ref, "err": err}


if __name__ == "__main__":
    main()
