"""One process per mesh row: the port's multi-controller runtime.

The counterpart of ``jax.distributed.initialize`` and
``jax.process_index``/``process_count``. `initialize` joins a
``torch.distributed`` process group, from torchrun's environment or from
explicit arguments; each rank then holds only its own shards of the grid
(`stepper.GridSharding`), runs K1 on them, and trades halo slabs with the
other ranks through point-to-point operations (`halo.Carrier`). Without a
process group every function here answers as the one process of a
single-controller run (index 0 of 1), and nothing else changes.

The backend is the caller's choice, never picked here: ``gloo`` moves CPU
tensors (a CUDA slab is staged through pinned host memory), so several
ranks may share one card; ``nccl`` moves device buffers and needs one card
per rank. NCCL refuses two ranks on one card only at its first collective,
so `initialize` checks the ranks' cards through the rendezvous store first
and raises its own error.

`launch` spawns ranks on one host under a deadline (tests, ``chip_smoke.py``):
a rank that fails, or a deadline that passes, ends every rank.

`axis_group` gives the sharded LM step (`training.spmd`) the sub-group of
ranks that share every mesh coordinate but one axis's (a mesh row or
column), created on every rank in one fixed order, once per mesh layout,
with the group's timeout.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 300.0
_TIMEOUT_S = [DEFAULT_TIMEOUT_S]   # the joined group's, for its sub-groups
_GROUPS: dict = {}                 # mesh layout -> {axes: AxisGroup}


@dataclasses.dataclass(frozen=True)
class ProcessDevice:
    """A mesh entry that may live on another rank: the owning process, an
    id that orders the process's devices, and the device in that process."""

    process_index: int
    id: int
    device: torch.device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> str | None:
    """The process group's backend, or None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def _card_identity(device) -> str:
    """What names a card across processes: its UUID where CUDA can say,
    else the device's name (``cuda:0``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return str(torch.cuda.get_device_properties(dev).uuid)
    return str(dev)


def rank_device(kind: str = "cuda") -> torch.device:
    """The device this rank drives: the CPU, or the card ``LOCAL_RANK``
    names (modulo the visible cards, so ranks may share one)."""
    if kind == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def _check_cards(store, rank: int, world_size: int, device) -> None:
    """Raise before NCCL does when two ranks name one card."""
    store.set(f"repro_torch/card/{rank}", _card_identity(device))
    cards = [store.get(f"repro_torch/card/{r}").decode()
             for r in range(world_size)]
    first: dict[str, int] = {}
    for r, card in enumerate(cards):
        if card in first:
            raise RuntimeError(
                f"backend 'nccl' needs one card per rank, but ranks "
                f"{first[card]} and {r} both name {card}; run ranks that "
                f"share one card with backend='gloo'")
        first[card] = r


def initialize(backend: str, *, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S, device=None) -> None:
    """Join the process group.

    `rank`, `world_size` and `init_method` default to torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``env://``); tests pass them,
    with a ``file://`` store. Every collective then waits at most
    `timeout_s`. Under ``nccl``, `device` is this rank's card (default
    `rank_device`), checked against the other ranks' before NCCL starts.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; call "
                           "finalize() first")
    if rank is None or world_size is None:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"initialize() without rank/world_size reads torchrun's "
                f"environment, which lacks {missing}")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(
        init_method or "env://", rank, world_size, timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        device = rank_device() if device is None else torch.device(device)
        _check_cards(store, rank, world_size, device)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    _TIMEOUT_S[0] = timeout_s


def join_torchrun(backend: str | None, device_kind: str = "cuda") -> bool:
    """Join the group torchrun's environment names when it names more
    than one rank and none is joined yet (the LM launchers); whether it
    joined. `backend` is the caller's (required then); under ``nccl``
    the rank's card is `rank_device`."""
    if process_count() > 1 or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if backend is None:
        raise SystemExit("torchrun started more than one rank: name the "
                         "process group's backend with --backend gloo|nccl")
    initialize(backend, device=rank_device(device_kind)
               if device_kind == "cuda" else None)
    return True


def finalize() -> None:
    """Leave the process group (nothing without one)."""
    _GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that differ from this one only along some mesh axes:
    `ranks` in coordinate order (row-major over the axes), this rank's
    `index` among them, and the backend's group (None for one rank)."""

    ranks: tuple[int, ...]
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_combos(names) -> list[tuple[str, ...]]:
    """The axes a mesh of axis `names` has groups along: each axis, and
    the batch axes ``('pod', 'data')`` together where both exist."""
    combos = [(n,) for n in names]
    if "pod" in names and "data" in names:
        combos.append(("pod", "data"))
    return combos


def mesh_ranks(mesh) -> np.ndarray:
    """The owning rank of every entry of a mesh of `ProcessDevice`s, in
    the mesh's shape."""
    return np.vectorize(lambda d: d.process_index, otypes=[int])(
        mesh.devices)


def axis_group(mesh, axes) -> AxisGroup:
    """This rank's group along mesh axis `axes` (a name, or a tuple of
    names whose coordinates combine row-major, as a spec entry's do).

    ``dist.new_group`` is collective over the whole process group, so the
    first call for a mesh layout creates the groups of every axis and of
    the batch axes ``('pod', 'data')`` on every rank in one fixed order,
    each with the joined group's timeout; later calls, for any mesh of the
    same layout, reuse them. A mesh over more than one rank must hold one
    entry per rank of the process group."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    ranks = mesh_ranks(mesh)
    key = (ranks.shape, tuple(ranks.flat), tuple(mesh.axis_names))
    if key not in _GROUPS:
        _GROUPS[key] = _make_groups(ranks, tuple(mesh.axis_names))
    return _GROUPS[key][axes]


def _make_groups(ranks: np.ndarray, names: tuple) -> dict:
    me = process_index()
    if ranks.size > 1 and sorted(ranks.flat) != list(range(process_count())):
        raise ValueError(
            f"a mesh over ranks {sorted(ranks.flat)} must hold each of the "
            f"{process_count()} ranks of the process group exactly once")
    where = np.argwhere(ranks == me)
    if len(where) != 1:
        raise ValueError(f"rank {me} holds {len(where)} entries of a mesh "
                         f"over ranks {ranks.tolist()}; it must hold one")
    pos = tuple(int(i) for i in where[0])
    timeout = datetime.timedelta(seconds=_TIMEOUT_S[0])
    out = {}
    for combo in axis_combos(names):
        dims = [names.index(n) for n in combo]
        rest = [i for i in range(ranks.ndim) if i not in dims]
        rows = np.transpose(ranks, rest + dims).reshape(
            -1, math.prod(ranks.shape[i] for i in dims))
        mine_at = int(np.ravel_multi_index(
            tuple(pos[i] for i in dims),
            tuple(ranks.shape[i] for i in dims)))
        for row in rows:
            row = tuple(int(r) for r in row)
            group = (dist.new_group(list(row), timeout=timeout)
                     if len(row) > 1 else None)
            if me in row:
                out[combo] = AxisGroup(row, mine_at, group)
    return out


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every rank (`obj` itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend() == "nccl" else None)
    dist.broadcast_object_list(box, src=0, device=dev)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's `obj`, in rank order (``[obj]`` without a group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# ranks on one host, under a deadline
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank: int, world_size: int, init_method: str,
                result_dir: str, args: tuple) -> None:
    """A spawned rank: run ``fn(rank, world_size, init_method, *args)``
    and write what it returns for the parent. An exception ends the
    process with a non-zero code."""
    out = fn(rank, world_size, init_method, *args)
    path = os.path.join(result_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


def launch(fn, world_size: int, args: tuple = (), *,
           timeout_s: float) -> list:
    """Run ``fn(rank, world_size, init_method, *args)`` in `world_size`
    spawned processes and return their results in rank order.

    `fn` must be importable (a module-level function); `init_method` is a
    ``file://`` store that only this launch uses. When a rank exits with
    a non-zero code, or `timeout_s` passes, every rank still running is
    killed and RuntimeError names the ranks and their exit codes.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    work = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_method = "file://" + os.path.join(work, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init_method, work, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = (f"ranks {failed} failed" if failed else
                       f"the deadline of {timeout_s:.0f} s passed")
                raise RuntimeError(f"{why}; exit codes {codes}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.05)
        results = []
        for r in range(world_size):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
