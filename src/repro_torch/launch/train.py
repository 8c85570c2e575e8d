"""Training launcher for the LM substrate.

The port of `repro.launch.train`: builds the mesh (`elastic.build_mesh`
over the one card ``--device`` names), places the parameters on it with the LM
sharding rules (`training.sharding.place` of `param_shardings`), restores
the newest checkpoint if present onto the same placement
(`steps.train_state_specs`' shardings), and runs the step loop with async
checkpointing and deadline-based straggler accounting. The mesh is 1x1,
so every leaf is stored whole on that card, also on a host with several:
a split over distinct devices waits for the sharded LM step (ROADMAP.md
queue 1, item 14a).

With --reduced (the default) it trains the smoke-scale config of any
architecture; --full trains the published width and depth.

  python -m repro_torch.launch.train --arch llama3.2-1b --reduced \\
      --steps 50 --batch 8 --seq 128 --ckpt "$(mktemp -d)"   # on the card
  python -m repro_torch.launch.train --device cpu --steps 6 --batch 2 \\
      --seq 32

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
from repro_torch.distributed import checkpoint, elastic
from repro_torch.models import lm
from repro_torch.models.params import tree_abstract, tree_init
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
    return ap


def restore_state(directory: str, cfg, opt, mesh) -> tuple[int, dict]:
    """The newest checkpoint in `directory` as a train state placed on
    `mesh` by ``train_state_specs(cfg)[1](mesh)`` (the step counter on the
    host, as a fresh state keeps it)."""
    params = tree_abstract(lm.param_specs(cfg))
    like = {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32)}
    shardings = dict(tree_paths(tsteps.train_state_specs(cfg)[1](mesh)))
    return checkpoint.restore(
        directory, like,
        placement_fn=lambda name, leaf: "cpu" if name == "['step']"
        else shd.device_for(shardings[name]))


def build(args) -> tuple:
    """``(cfg, opt, train_step, pipe)`` for parsed `args`: what `main`
    steps, and the one source for any caller that must step as it does
    (a profiler timing one more step on the state `main` returns)."""
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    opt, train_step = tsteps.make_train_step(cfg, lr=args.lr,
                                             chunk=min(args.seq, 2048),
                                             accum=args.accum)
    pipe = SyntheticPipeline(PipelineConfig(args.batch, args.seq,
                                            cfg.vocab_size))
    return cfg, opt, train_step, pipe


def main(argv=None, records: list | None = None):
    """CLI entry point: build mesh, restore/init state, run the step loop.

    Returns the final train state. `records`, when given, receives one dict
    a step: ``step``, ``loss``, ``grad_norm`` and ``ms`` (host clock around
    the step, which ends in reading the loss, so the device has finished).
    """
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, opt, train_step, pipe = build(args)
    # the one card `--device` names: a split over cards waits for item 14a
    mesh = elastic.build_mesh(devices=[dev])
    print(f"mesh: {mesh.shape} over {mesh.devices.size} devices")
    spec_tree = lm.param_specs(cfg)

    start_step = 0
    if args.ckpt and checkpoint.latest_step(args.ckpt) is not None:
        start_step, state = restore_state(args.ckpt, cfg, opt, mesh)
        print(f"resumed from step {start_step}")
    else:
        params = shd.place(tree_init(spec_tree, seed=args.seed, device="cpu"),
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
            print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"{dt*1e3:.0f}ms{tag}", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.wait_pending()
        print(f"checkpoints: {checkpoint.all_steps(args.ckpt)}")
    print(f"done; stragglers observed: {guard.stragglers}")
    return state


if __name__ == "__main__":
    main()
