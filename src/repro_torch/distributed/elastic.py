"""Elastic rescale + slice health tracking.

The port of `repro.distributed.elastic`. The checkpoint format holds full
logical arrays, so elasticity reduces to: a changed device set -> rebuild
the mesh -> restore the latest checkpoint -> rebuild the stepper.
`ElasticStencilRun` packages that loop for the distributed super-stepper:
on every grow or shrink it re-resolves the per-shard K1 plan from the plan
registry (the kernel runs on the NEW local extended block, another tuning
key) before resuming from the latest checkpoint.

`plan_mesh` returns the largest production-shaped mesh a healthy device
count supports (2 pods -> 1 pod -> debug shapes). `HealthMonitor` is the
host-side heartbeat registry a launcher polls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.launch import mesh as launch_mesh


def plan_mesh(n_devices: int) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest supported mesh for the healthy device count."""
    if n_devices >= 512:
        return (2, 16, 16), ("pod", "data", "model")
    if n_devices >= 256:
        return (16, 16), ("data", "model")
    # degraded/debug shapes: keep 'model' as the minor axis
    for model in (16, 8, 4, 2, 1):
        if n_devices % model == 0 and n_devices >= model:
            return (n_devices // model, model), ("data", "model")
    return (n_devices, 1), ("data", "model")


def build_mesh(n_devices: int | None = None, devices=None):
    """Build the `plan_mesh` shape over the first `n_devices` of a pool.

    `devices` is the pool (default: the card's devices; under a process
    group of more than one rank, every rank's device, `launch.mesh.
    rank_devices`, which is the reference's ``build_mesh()`` over every
    device: 4 ranks give (1, 4)); it may repeat a device, as
    ``[cuda:0] * 4`` lets one card host four shards. A shrink takes a
    prefix of the pool, so it builds a genuinely smaller mesh.
    """
    if devices is None:
        from repro_torch.distributed import process

        pool = (launch_mesh.rank_devices() if process.process_count() > 1
                else launch_mesh.local_devices())
    else:
        pool = list(devices)
    n = len(pool) if n_devices is None else n_devices
    if n > len(pool):
        raise ValueError(
            f"requested a {n}-device mesh but only {len(pool)} devices "
            "are healthy")
    shape, axes = plan_mesh(n)
    return launch_mesh.make_mesh(shape, axes, pool[:n])


@dataclasses.dataclass
class HealthMonitor:
    """Heartbeat registry with a deadline; launcher polls healthy_slices()."""

    slices: tuple[str, ...]
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last_beat = {s: now for s in self.slices}

    def heartbeat(self, slice_id: str) -> None:
        """Record a liveness beat from `slice_id` (resets its deadline)."""
        self._last_beat[slice_id] = self.clock()

    def healthy_slices(self) -> list[str]:
        """Slices whose last beat is within the timeout."""
        now = self.clock()
        return [s for s, t in self._last_beat.items()
                if now - t <= self.timeout_s]

    @property
    def degraded(self) -> bool:
        """True when at least one slice has missed its deadline."""
        return len(self.healthy_slices()) < len(self.slices)


def rescale_restore(ckpt_dir: str, tree_like, make_placement,
                    n_devices: int | None = None, devices=None):
    """Restore the latest checkpoint onto a mesh for the current device set.

    Rebuilds the (possibly reduced) mesh first; ``make_placement(mesh,
    name, leaf)`` gives each leaf's device. Returns ``(step, state, mesh)``.
    """
    from repro_torch.distributed import checkpoint

    new_mesh = build_mesh(n_devices, devices)
    step, state = checkpoint.restore(
        ckpt_dir, tree_like,
        placement_fn=lambda name, leaf: make_placement(new_mesh, name, leaf))
    return step, state, new_mesh


class ElasticStencilRun:
    """A distributed stencil run that survives mesh grows and shrinks.

        run = ElasticStencilRun(spec, state, coeffs, ckpt_dir, t_block=2,
                                plan="auto", overlap="auto",
                                devices=[cuda0] * 4)
        run.advance(k)            # k time steps on the current mesh
        run.save()                # mesh-agnostic checkpoint
        run.rescale(n_healthy)    # rebuild the mesh over the healthy set,
                                  # re-resolve the per-shard plan from the
                                  # registry, resume from the checkpoint

    Only the mesh-agnostic pieces (spec, global state, coefficients, step
    count) carry across a rescale. The plan resolves at (re)build time,
    keyed on the per-shard extended block, so a registry tuned for both
    mesh sizes replays without a search (`plan_source`).
    """

    def __init__(self, spec, state, coeffs, ckpt_dir: str, *,
                 t_block: int = 2, plan=None, overlap="auto",
                 compress: bool = False, n_devices: int | None = None,
                 devices=None):
        self.spec = spec
        self.ckpt_dir = ckpt_dir
        self.t_block = t_block
        self.overlap = overlap
        self.compress = compress
        self._plan_req = plan
        self._pool = list(devices) if devices is not None else None
        self.grid_shape = tuple(state[0].shape)
        self.state = state
        self.coeffs = coeffs
        self.steps_done = 0
        self._rebuild(n_devices)

    def _rebuild(self, n_devices: int | None) -> None:
        from repro_torch.distributed import stepper

        self.mesh = build_mesh(n_devices, devices=self._pool)
        self.plan_source = None
        if self._plan_req == "auto":
            self.plan, self.plan_source = stepper.resolve_shard_plan(
                self.spec, self.mesh, self.grid_shape, self.t_block,
                word_bytes=self.state[0].element_size())
        else:
            self.plan = self._plan_req

    def advance(self, n_steps: int):
        """Run `n_steps` more time steps on the current mesh."""
        from repro_torch.distributed import stepper

        self.state = stepper.run_distributed(
            self.spec, self.mesh, self.state, self.coeffs, n_steps,
            t_block=self.t_block, plan=self.plan, compress=self.compress,
            overlap=self.overlap)
        self.steps_done += n_steps
        return self.state

    def save(self) -> str:
        """Mesh-agnostic checkpoint of the current state at steps_done."""
        from repro_torch.distributed import checkpoint

        return checkpoint.save(
            self.ckpt_dir, self.steps_done,
            {"cur": self.state[0], "prev": self.state[1]})

    def rescale(self, n_devices: int | None = None, devices=None):
        """Grow or shrink onto `n_devices`; resume from the latest ckpt."""
        from repro_torch.distributed import checkpoint
        from repro_torch.distributed.stepper import GridSharding

        if devices is not None:
            self._pool = list(devices)
        self._rebuild(n_devices)
        home = GridSharding(self.mesh).devices()[0][0]
        like = {"cur": self.state[0], "prev": self.state[1]}
        self.steps_done, restored = checkpoint.restore(
            self.ckpt_dir, like, placement_fn=lambda _name, _leaf: home)
        self.state = (restored["cur"], restored["prev"])
        return self.mesh
