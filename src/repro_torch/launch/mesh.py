"""Device meshes: the distributed stencil stepper's and the LM's.

The port of `repro.launch.mesh`. A `Mesh` is an object array of mesh
entries plus axis names. On one controller (the default) the entries are
`torch.device`s, and one process holds every shard of the grid as a tensor
on its mesh device, as the reference drives every device of its mesh from
one controller. A device may appear more than once: ``[cuda:0] * 4`` is
how one card hosts a 2x2 mesh, whose halo exchange is then
device-to-device copies on that card (peer copies over NVLink where the
devices differ). Under a process group (`distributed.process`) the
entries are `ProcessDevice`s, each owned by one rank: `make_process_mesh`
all-gathers every rank's local devices into rows, one row per rank, and
`make_mesh` takes any layout of them over the ranks. `rank_mesh` lays one
device a rank over any shape, rank order row-major: the sharded LM
step's mesh (`training.spmd`), one rank per mesh device, as the
reference's mesh holds one device per entry.

The LM half: `production_layout` and `make_production_mesh` (16x16
``('data', 'model')``, or 2x16x16 with ``'pod'`` in front), `batch_axes` and `model_axis`, which
`training.sharding` reads, and `abstract_mesh`, a mesh of ``meta``
devices: the port's ``jax.sharding.AbstractMesh``, on which the dry-run
prices 256 and 512 devices that no single host holds.
"""

from __future__ import annotations

import dataclasses
import itertools
import types

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import process
from repro_torch.distributed.process import ProcessDevice


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    `torch.device`s (or `ProcessDevice`s) whose axes are
    ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        devices = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, {devices})"


def local_devices(device=None) -> list[torch.device]:
    """The local devices of `device`'s kind: every card for ``"cuda"``
    (the default; raises without one), one CPU for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def device_pool(n: int, device=None) -> list[torch.device]:
    """`n` mesh devices from the local devices of `device`'s kind, taken
    round robin: with fewer cards than shards, shards share cards."""
    return list(itertools.islice(itertools.cycle(local_devices(device)), n))


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A `Mesh` of `shape` over exactly ``prod(shape)`` devices (default:
    the card's devices round robin, `device_pool`). `ProcessDevice`
    entries stay as they are, in any layout over the ranks."""
    n = int(np.prod(shape))
    pool = device_pool(n) if devices is None else list(devices)
    if len(pool) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got "
                         f"{len(pool)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [d if isinstance(d, ProcessDevice) else torch.device(d)
               for d in pool]
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


def production_layout(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """``(shape, axes)`` of the production mesh: 16x16 = 256 devices
    ``('data', 'model')``; two pods add a ``'pod'`` axis in front
    (2x16x16)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The `production_layout` mesh over `devices` (default: the card's
    devices round robin, `device_pool`)."""
    return make_mesh(*production_layout(multi_pod), devices)


def abstract_mesh(shape, axes) -> Mesh:
    """A `Mesh` of `shape` whose every device is ``meta``: axis names and
    sizes with no device behind them."""
    return make_mesh(shape, axes,
                     [torch.device("meta")] * int(np.prod(shape)))


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    devices=None) -> Mesh:
    """Small mesh for tests and the chip check: ``devices=[cpu] * 4`` on
    the CPU, the card's devices round robin by default."""
    return make_mesh(shape, axes, devices)


def process_grid(devices) -> list[list]:
    """Arrange `devices` as a rectangular (process x local-device) grid.

    Row p holds exactly the devices owned by process p, rows ordered by
    ``process_index``, devices within a row by ``id``, so crossing rows
    crosses hosts. Raises when the processes own unequal device counts.
    Pure: only ``.process_index`` and ``.id`` are read, so tests drive it
    with stand-in objects.
    """
    devs = list(devices)
    if not devs:
        raise ValueError("process_grid needs at least one device")
    procs = sorted({d.process_index for d in devs})
    rows = [sorted((d for d in devs if d.process_index == p),
                   key=lambda d: d.id) for p in procs]
    counts = {p: len(row) for p, row in zip(procs, rows)}
    if len(set(counts.values())) != 1:
        raise ValueError(
            f"uneven process topology {counts}: a multi-host mesh needs the "
            "same local device count on every process — drop the lame host "
            "and rebuild over the healthy subset "
            "(repro_torch.distributed.elastic.build_mesh)")
    return rows


def make_process_mesh(devices=None) -> Mesh:
    """Mesh keyed on the process topology (`process_grid`): row p is the
    local devices of process p, so the 'data' axis (grid z) crosses
    processes and 'model' (grid y) stays on one process's devices.

    Under a process group, `devices` are this rank's local devices
    (default: its card, `process.rank_device`, or the CPU when there is
    no card); every rank's list is all-gathered as `ProcessDevice`s, ids in
    list order, and the mesh is ``(process_count, n_local)``. Without one,
    `torch.device`s count as process 0 with their index as id, and the
    mesh degenerates to ``(1, n_local)``; stand-ins with
    ``.process_index``/``.id`` and a ``.device`` pass through to their
    device.
    """
    if process.process_count() > 1:
        if devices is None:
            kind = "cuda" if torch.cuda.is_available() else "cpu"
            devices = [process.rank_device(kind)]
        mine = [ProcessDevice(process.process_index(), k, torch.device(d))
                for k, d in enumerate(devices)]
        rows = process_grid([d for part in process.all_gather_object(mine)
                             for d in part])
        return make_mesh((len(rows), len(rows[0])), ("data", "model"),
                         [d for row in rows for d in row])
    devs = local_devices() if devices is None else list(devices)
    tagged = [d if hasattr(d, "process_index") else types.SimpleNamespace(
        process_index=0, id=k, device=d) for k, d in enumerate(devs)]
    rows = process_grid(tagged)
    flat = [getattr(d, "device", d) for row in rows for d in row]
    return make_mesh((len(rows), len(rows[0])), ("data", "model"), flat)


def rank_devices(device=None) -> list:
    """Every rank's device, as `ProcessDevice`s in rank order (collective
    under a process group): this rank's is `process.rank_device` of
    `device`'s kind (default: the card where there is one, else the
    CPU), or `device` itself when it names an index."""
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        dev = process.rank_device(kind)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = process.rank_device("cuda")
    mine = ProcessDevice(process.process_index(), 0, dev)
    return process.all_gather_object(mine)


def rank_mesh(shape, axes=("data", "model"), device=None) -> Mesh:
    """A mesh of `shape` with one entry per rank, ranks in row-major
    order (`rank_devices`); its size must be the process count."""
    return make_mesh(shape, axes, rank_devices(device))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over (DP/FSDP axes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh: Mesh) -> str:
    """Mesh axis model-parallel (TP) parameters are sharded over."""
    return "model"
