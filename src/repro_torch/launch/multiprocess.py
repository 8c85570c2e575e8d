"""One distributed stencil run as one rank per mesh row (torchrun).

Each rank joins the process group from torchrun's environment
(`distributed.process.initialize`), builds the process mesh over its
local devices (`launch.mesh.make_process_mesh`: row p is rank p's
devices, so grid z crosses ranks), draws the same seed-0 problem, and
runs `distributed.stepper.run_distributed` (K1 per shard at
``plan="auto"``, t_block 2) on its own shards; rank 0 prints one JSON
line. With ``--verify`` rank 0 holds the result against `ops.naive`,
bitwise (exit 1 otherwise).

  # one card shared by two ranks: gloo, halos staged through host memory
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.multiprocess --backend gloo \
      --devices-per-rank 2 --grid 256,256,256 --steps 4 --verify
  # one card per rank
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.multiprocess --backend nccl --verify
  # the CPU
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.multiprocess --backend gloo --device cpu \
      --devices-per-rank 2 --grid 16,12,8 --steps 4 --verify

The backend is the caller's choice: gloo lets ranks share a card, NCCL
needs one card per rank and refuses two ranks on one
(`process.initialize`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.core import stencils as st
from repro_torch.device import resolve_device
from repro_torch.distributed import process, stepper
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_process_mesh

T_BLOCK = 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m torch.distributed.run ... -m "
             "repro_torch.launch.multiprocess")
    ap.add_argument("--backend", required=True, choices=process.BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the rank's card) or 'cpu'")
    ap.add_argument("--devices-per-rank", type=int, default=1,
                    help="mesh columns per rank (the rank's device repeated)")
    ap.add_argument("--stencil", default="7pt-var", choices=sorted(st.SPECS))
    ap.add_argument("--grid", default="512,512,512")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="rank 0 holds the result against ops.naive")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    kind = resolve_device(args.device).type
    process.initialize(args.backend)
    try:
        dev = process.rank_device(kind)
        if kind == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_process_mesh([dev] * args.devices_per_rank)
        spec = st.SPECS[args.stencil]
        grid = tuple(int(v) for v in args.grid.split(","))
        draw = st.random_problem if kind == "cuda" else st.make_problem
        state, coeffs = draw(spec, grid, seed=0, device=dev)
        t0 = time.perf_counter()
        out = stepper.run_distributed(spec, mesh, state, coeffs, args.steps,
                                      T_BLOCK, plan="auto",
                                      overlap=args.overlap)
        if kind == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        line = {"stencil": spec.name, "grid": list(grid),
                "mesh": list(mesh.devices.shape),
                "ranks": process.process_count(), "backend": args.backend,
                "device": str(dev), "steps": args.steps,
                "t_block": T_BLOCK, "overlap": args.overlap,
                "call_s": seconds}
        code = 0
        if args.verify and process.process_index() == 0:
            want = ops.naive(spec, state, coeffs, args.steps)
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(out, want))
            bitwise = all(torch.equal(a, b) for a, b in zip(out, want))
            line.update(max_abs_err=err, bitwise=bitwise)
            code = 0 if bitwise else 1
        if process.process_index() == 0:
            print(json.dumps(line), flush=True)
        process.barrier()
        return code
    finally:
        process.finalize()


if __name__ == "__main__":
    sys.exit(main())
