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
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 300.0


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


def finalize() -> None:
    """Leave the process group (nothing without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


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
