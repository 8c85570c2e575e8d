"""Training launcher for the LM substrate.

The port of `repro.launch.train`: builds the mesh (`elastic.build_mesh`),
places the train state on it with the LM sharding rules
(`training.sharding.place` of `param_shardings`), restores the newest
checkpoint if present onto the same placement (`steps.train_state_specs`'
shardings), and runs the step loop with async checkpointing and
deadline-based straggler accounting. In one process the mesh is the 1x1
mesh of the one card ``--device`` names, every leaf whole on it. Under
torchrun with more than one rank (``--backend gloo|nccl``, the caller's
choice, as for `launch.multiprocess`) the launcher joins the process
group and the mesh is `plan_mesh` over every rank's device (4 ranks give
(1, 4)): each rank holds its blocks of the state and runs the sharded
step (`training.spmd`) on its rows of each global batch; checkpoints hold
full logical arrays written by rank 0, and rank 0 prints.

With --reduced (the default) it trains the smoke-scale config of any
architecture; --full trains the published width and depth.

  python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt "$(mktemp -d)"   # on the card
  python -m repro_torch.launch.train --device cpu --steps 6 --batch 2 \\
      --seq 32
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --backend gloo --device cpu --steps 4 \\
      --batch 8 --seq 32

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
GPU rather than falling back.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint, elastic, process
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models import lm
from repro_torch.models.params import tree_abstract
from repro_torch.optim.optimizers import tree_paths
from repro_torch.training import sharding as shd
from repro_torch.training import steps as tsteps


class StepGuard:
    """Deadline-based straggler accounting over the train-step clock.

    Flags steps slower than `factor` x the rolling median; on clusters this
    triggers scheduler rebalancing / health checks, here it is logged and
    counted.
    """

    def __init__(self, factor: float = 3.0):
        self.times: list[float] = []
        self.factor = factor
        self.stragglers = 0

    def observe(self, dt: float) -> bool:
        """Record one step time; True if it crossed the straggler deadline."""
        slow = (len(self.times) >= 5
                and dt > self.factor * float(np.median(self.times)))
        self.times.append(dt)
        if slow:
            self.stragglers += 1
        return slow


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, plus --device."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    ap.add_argument("--backend", choices=process.BACKENDS, default=None,
                    help="the process group's backend under torchrun with "
                         "more than one rank (required there)")
    return ap


def restore_state(directory: str, cfg, opt, mesh) -> tuple[int, dict]:
    """The newest checkpoint in `directory` as a train state placed on
    `mesh` by ``train_state_specs(cfg)[1](mesh)`` (the step counter on the
    host, as a fresh state keeps it): this rank's blocks on a process
    mesh."""
    params = tree_abstract(lm.param_specs(cfg))
    like = {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}
    tree = tsteps.train_state_specs(cfg)[1](mesh)
    shardings = dict(tree_paths(tree))
    return checkpoint.restore(
        directory, like,
        placement_fn=lambda name, leaf: "cpu" if name == "['step']"
        else shd.device_for(shardings[name]), shardings=tree)


def build(args, mesh=None) -> tuple:
    """``(cfg, opt, train_step, pipe)`` for parsed `args`: what `main`
    steps, and the one source for any caller that must step as it does
    (a profiler timing one more step on the state `main` returns). A
    process `mesh` makes the step the sharded one."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    opt, train_step = tsteps.make_train_step(cfg, lr=args.lr,
                                             chunk=min(args.seq, 2048),
                                             accum=args.accum, mesh=mesh)
    pipe = SyntheticPipeline(PipelineConfig(args.batch, args.seq,
                                            cfg.vocab_size))
    return cfg, opt, train_step, pipe


def main(argv=None, records: list | None = None):
    """CLI entry point: build mesh, restore/init state, run the step loop.

    Returns the final train state (this rank's blocks under a process
    group of more than one rank). `records`, when given, receives one dict
    a step: ``step``, ``loss``, ``grad_norm`` and ``ms`` (host clock
    around the step, which ends in reading the loss, so the device has
    finished).
    """
    args = build_parser().parse_args(argv)
    joined = process.join_torchrun(args.backend,
                                   resolve_device(args.device).type)
    try:
        return _run(args, records)
    finally:
        if joined:
            process.finalize()


def _run(args, records):
    dev = resolve_device(args.device)
    sharded = process.process_count() > 1
    if sharded:
        dev = process.rank_device(dev.type)
        mesh = elastic.build_mesh(devices=launch_mesh.rank_devices(dev))
    else:
        mesh = elastic.build_mesh(devices=[dev])
    cfg, opt, train_step, pipe = build(args, mesh if sharded else None)
    lead = process.process_index() == 0

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    say(f"mesh: {mesh.shape} over {mesh.devices.size} devices")
    spec_tree = lm.param_specs(cfg)
    state_sh = tsteps.train_state_specs(cfg)[1](mesh)

    start_step = 0
    if args.ckpt and checkpoint.latest_step(args.ckpt) is not None:
        start_step, state = restore_state(args.ckpt, cfg, opt, mesh)
        say(f"resumed from step {start_step}")
    else:
        params = shd.init_blocks(spec_tree, args.seed,
                                 shd.param_shardings(mesh, spec_tree))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}

    ckpt = checkpoint.AsyncCheckpointer(args.ckpt) if args.ckpt else None
    guard = StepGuard()

    for step in range(start_step, args.steps):
        batch = pipe.get_batch(step, cfg, device=dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = guard.observe(dt)
        gnorm = float(metrics["grad_norm"])
        if records is not None:
            records.append({"step": step, "loss": loss, "grad_norm": gnorm,
                            "ms": dt * 1e3})
        tag = " [straggler]" if slow else ""
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                f"{dt*1e3:.0f}ms{tag}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, state_sh if sharded else None)
    if ckpt:
        ckpt.wait_pending()
        say(f"checkpoints: {checkpoint.all_steps(args.ckpt)}")
    say(f"done; stragglers observed: {guard.stragglers}")
    return state


if __name__ == "__main__":
    main()
