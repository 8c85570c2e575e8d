"""Device meshes for the distributed stencil stepper.

The port of `repro.launch.mesh`, stencil half. The port runs one process
that holds every shard of the grid as a tensor on its mesh device, as the
reference drives every device of its mesh from one controller: a `Mesh` is
an object array of `torch.device`s plus axis names. A device may appear
more than once: ``[cuda:0] * 4`` is how one card hosts a 2x2 mesh, whose
halo exchange is then device-to-device copies on that card (peer copies
over NVLink where the devices differ).

`make_production_mesh`, `batch_axes` and `model_axis` belong to the LM
half and are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
import types

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices: ``devices`` is an object array of
    `torch.device`s whose axes are ``axis_names``."""

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
    the card's devices round robin, `device_pool`)."""
    n = int(np.prod(shape))
    pool = device_pool(n) if devices is None else list(devices)
    if len(pool) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got "
                         f"{len(pool)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in pool]
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


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
    local devices of process p, so the 'data' axis (grid z) crosses hosts
    and 'model' (grid y) stays on one host's cards.

    One process holds the whole mesh in this port, so `torch.device`s
    count as process 0 with their index as id, and the mesh degenerates
    to ``(1, n_local)``. Stand-ins with ``.process_index``/``.id`` and a
    ``.device`` pass through to their device.
    """
    devs = local_devices() if devices is None else list(devices)
    tagged = [d if hasattr(d, "process_index") else types.SimpleNamespace(
        process_index=0, id=k, device=d) for k, d in enumerate(devs)]
    rows = process_grid(tagged)
    flat = [getattr(d, "device", d) for row in rows for d in row]
    return make_mesh((len(rows), len(rows[0])), ("data", "model"), flat)
