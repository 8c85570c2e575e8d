"""Mesh-agnostic, atomic, async checkpointing.

The port of `repro.distributed.checkpoint`, with its on-disk layout:

    <dir>/step_<N>/
        manifest.json          # step, leaf names, shapes, dtypes
        arrays.npz             # one entry per tree leaf
        COMMIT                 # written last: presence == validity

Leaf names are the reference's (`jax.tree_util.keystr` of dict, list and
tuple trees: ``"['cur']"``, ``"[0]"``, dict keys sorted), and bfloat16
leaves are stored as two-byte void entries named ``bfloat16`` in the
manifest, as numpy stores the reference's, so a checkpoint written by
either package restores in the other. Writes go to a temporary directory
that is `os.replace`d in, so a killed process never leaves a
half-checkpoint. Checkpoints hold full logical arrays: `restore` places
each leaf wherever `placement_fn` says, which is what makes an elastic
rescale (`distributed.elastic`) a restore onto another mesh.

Under a process group (`distributed.process`) the tree is the global one
every rank holds (`stepper.run_distributed` returns it on every rank), or,
given its `shardings` (a sharded LM train state), this rank's blocks,
which `save` first gathers into full logical arrays on every rank
(`training.sharding.gather`): rank 0 alone writes it, and every rank
waits at a barrier until it is committed. `restore` runs on every rank
and, given `shardings`, cuts each rank's block from the full arrays
(`training.sharding.shard`), so a run checkpointed at one world size or
mesh resumes at another, or in one process.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed import process
from repro_torch.optim.optimizers import tree_paths

_COMMIT = "COMMIT"


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, f"{prefix}[{k!r}]")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype name for the manifest (a
    device leaf's ``.cpu()`` is that copy; a host leaf is copied)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.device == leaf.device:
            t = t.clone()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A tensor over a writable array `np.load` returned (no copy)."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.kind == "V" or dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _whole(tree, shardings):
    """`tree` with every block gathered whole (the tree itself without
    `shardings`)."""
    if shardings is None:
        return tree
    from repro_torch.training import sharding

    return sharding.gather(tree, shardings)


def save(directory: str, step: int, tree, *, keep_last: int = 3,
         shardings=None) -> str:
    """Synchronous atomic checkpoint of `tree` at `step` (under a process
    group: written by rank 0, committed for every rank on return). With
    `shardings` (a same-structured tree of `NamedSharding`s) `tree` holds
    this rank's blocks, gathered whole first on every rank."""
    tree = _whole(tree, shardings)
    if process.process_count() > 1:
        final = os.path.join(directory, f"step_{step:010d}")
        if process.process_index() == 0:
            _write(directory, step, tree, keep_last)
        process.barrier()
        return final
    return _write(directory, step, tree, keep_last)


def _write(directory: str, step: int, tree, keep_last: int) -> str:
    """Write and commit one checkpoint; its directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays, dtypes = {}, {}
        for name, leaf in tree_paths(tree):
            arrays[name], dtypes[name] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "leaves": [{"name": n, "shape": list(a.shape),
                        "dtype": dtypes[n]} for n, a in arrays.items()],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, _COMMIT), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    """Sorted steps with a committed (COMMIT-marked) checkpoint present."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, _COMMIT)):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    """Newest committed step in `directory`, or None when empty."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like, *, step: int | None = None,
            placement_fn: Callable[[str, Any], Any] | None = None,
            shardings=None):
    """Restore a checkpoint into the structure of `tree_like`.

    ``placement_fn(name, leaf)`` gives each leaf's device (e.g. a mesh
    other than the one that saved it); by default a leaf lands on the
    device of the matching tensor in `tree_like`, else on the CPU. With
    `shardings` (a tree of `NamedSharding`s shaped as `tree_like`) each
    leaf is cut to this rank's block on a process mesh and goes, by
    default, to `sharding.device_for` its sharding. Returns ``(step,
    tree)``.
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    pairs = tree_paths(tree_like)
    missing = [n for n, _ in pairs if n not in arrays]
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves {missing}")
    blocks = {}
    if shardings is not None:
        from repro_torch.training import sharding

        blocks = dict(tree_paths(shardings))
    leaves = {}
    for name, leaf in pairs:
        sh = blocks.get(name)
        if placement_fn is not None:
            device = placement_fn(name, leaf)
        elif sh is not None:
            device = sharding.device_for(sh)
        else:
            device = (leaf.device if isinstance(leaf, torch.Tensor)
                      else "cpu")
        t = _from_numpy(arrays[name], dtypes[name])
        if sh is not None and sharding.is_process_mesh(sh.mesh):
            t = sharding.shard(t, sh)
        leaves[name] = t.to(device)
    return step, _rebuild(tree_like, leaves)


class AsyncCheckpointer:
    """Background-thread checkpointer with at-most-one pending save.

    Under a process group rank 0's thread writes, and `wait_pending` is a
    barrier: every rank calls `save` and `wait_pending` alike.
    """

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, shardings=None) -> None:
        """Snapshot `tree` to host and write the checkpoint off-thread
        (rank 0's thread under a process group); with `shardings`, `tree`
        holds this rank's blocks, gathered whole first on every rank."""
        self.wait_pending()
        tree = _whole(tree, shardings)
        if process.process_index() != 0:
            return
        # snapshot on the caller's thread: the next step may overwrite the
        # device tensors
        snapshot = _rebuild(tree, {
            name: (leaf.detach().to("cpu", copy=True)
                   if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for name, leaf in tree_paths(tree)})

        def _run():
            try:
                _write(self.directory, step, snapshot, self.keep_last)
            except BaseException as e:  # surfaced on the next wait
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait_pending(self) -> None:
        """Join the in-flight save (if any) and re-raise its error; under
        a process group, wait until rank 0's save is committed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if process.process_count() > 1:
            process.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def install_signal_handler(checkpointer: AsyncCheckpointer,
                           get_state: Callable[[], tuple[int, Any]]) -> None:
    """Snapshot on SIGTERM (cluster preemption notice), then re-raise."""
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        step, tree = get_state()
        checkpointer.wait_pending()
        save(checkpointer.directory, step, tree,
             keep_last=checkpointer.keep_last)
        if callable(prev):
            prev(signum, frame)

    signal.signal(signal.SIGTERM, _handler)
