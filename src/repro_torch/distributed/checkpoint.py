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

_COMMIT = "COMMIT"


def _tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, f"{prefix}[{k!r}]")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype name for the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2").copy(), "bfloat16"
        a = t.numpy().copy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.kind == "V" or dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save(directory: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Synchronous atomic checkpoint of `tree` at `step`."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays, dtypes = {}, {}
        for name, leaf in _tree_paths(tree):
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
            placement_fn: Callable[[str, Any], Any] | None = None):
    """Restore a checkpoint into the structure of `tree_like`.

    ``placement_fn(name, leaf)`` gives each leaf's device (e.g. a mesh
    other than the one that saved it); by default a leaf lands on the
    device of the matching tensor in `tree_like`, else on the CPU.
    Returns ``(step, tree)``.
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
    pairs = _tree_paths(tree_like)
    missing = [n for n, _ in pairs if n not in arrays]
    if missing:
        raise ValueError(f"checkpoint at step {step} missing leaves {missing}")
    leaves = {}
    for name, leaf in pairs:
        if placement_fn is not None:
            device = placement_fn(name, leaf)
        else:
            device = (leaf.device if isinstance(leaf, torch.Tensor)
                      else "cpu")
        leaves[name] = _from_numpy(arrays[name], dtypes[name]).to(device)
    return step, _rebuild(tree_like, leaves)


class AsyncCheckpointer:
    """Background-thread checkpointer with at-most-one pending save."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        """Snapshot `tree` to host and write the checkpoint off-thread."""
        self.wait_pending()
        # snapshot on the caller's thread: the next step may overwrite the
        # device tensors
        snapshot = _rebuild(tree, {
            name: (leaf.detach().to("cpu", copy=True)
                   if isinstance(leaf, torch.Tensor) else np.array(leaf))
            for name, leaf in _tree_paths(tree)})

        def _run():
            try:
                save(self.directory, step, snapshot, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on the next wait
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait_pending(self) -> None:
        """Join the in-flight save (if any) and re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
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
