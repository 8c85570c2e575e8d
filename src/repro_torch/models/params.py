"""Parameter specs with logical sharding axes.

The port of `repro.models.params`. Every parameter is declared once as a
`ParamSpec` (shape, dtype, logical axes); the same tree drives real
initialization (`tree_init`), `TensorSpec` trees for the dry-run
(`tree_sds`: shapes and dtypes, no storage), the logical-to-mesh sharding
rules (`training.sharding`) and the parameter count. A parameter tree is
a tree of dicts and lists whose leaves are tensors, in the reference's
layout (``wq`` is ``(d, heads, head_dim)`` and so on), so weights cross
between the packages without transposes (`from_reference`).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis names, len == ndim
    dtype: str = "bfloat16"
    init_scale: float = 1.0            # stddev multiplier over fan-in rule

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def sds(self) -> "TensorSpec":
        return TensorSpec(self.shape, self.torch_dtype)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one tensor, with no storage: the port's
    ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def sorted_leaves(tree) -> list:
    """The leaves in JAX's flattening order: dict keys sorted, lists in
    order. The reference numbers its init streams in this order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


# the threads that draw a tree's leaves (`tree_init`, `sharding.init_blocks`)
INIT_WORKERS = max(1, min(8, os.cpu_count() or 1))


def init_array(s: ParamSpec, seed: int, i: int) -> np.ndarray:
    """Leaf `i`'s float32 host array, drawn as the reference draws it:
    ones (or zeros at ``init_scale=0``) for vectors, else normal over the
    fan-in from ``default_rng((seed, i))``."""
    if len(s.shape) == 1:  # norm scales & biases
        return (np.ones(s.shape, np.float32) if s.init_scale
                else np.zeros(s.shape, np.float32))
    rng = np.random.default_rng((seed, i))
    fan_in = int(np.prod(s.shape[:-1]))
    std = s.init_scale / np.sqrt(max(fan_in, 1))
    return rng.standard_normal(s.shape).astype(np.float32) * std


def sorted_build(spec_tree, leaf):
    """`spec_tree` with each spec replaced by ``leaf(spec)``, called in
    JAX's flattening order; dicts come back with their keys sorted."""
    if isinstance(spec_tree, dict):
        return {k: sorted_build(spec_tree[k], leaf)
                for k in sorted(spec_tree)}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(sorted_build(v, leaf) for v in spec_tree)
    return leaf(spec_tree)


def tree_init(spec_tree, seed: int = 0, device=None):
    """Deterministic host-side init, the reference's numbers for `seed`.

    Leaf *i* of the reference's JAX flattening (dict keys sorted, lists in
    order) draws from ``default_rng((seed, i))``; each float32 array is
    rounded to the spec's dtype (round-to-nearest-even, as ``jnp.asarray``
    does) and placed on `device` (`resolve_device`: the card unless
    ``"cpu"`` is named; raises without a GPU). Dicts come back with their
    keys sorted, as the reference's do. The draws run on a few threads
    (numpy releases the GIL while it fills an array), since each leaf has
    its own stream.
    """
    device = resolve_device(device)
    specs = sorted_leaves(spec_tree)
    with ThreadPoolExecutor(max_workers=INIT_WORKERS) as pool:
        arrays = pool.map(lambda i: init_array(specs[i], seed, i),
                          range(len(specs)))
        return sorted_build(spec_tree, lambda s: torch.from_numpy(
            next(arrays)).to(device=device, dtype=s.torch_dtype))


def tree_sds(spec_tree):
    """The `TensorSpec` of every leaf, dicts with their keys sorted as
    `tree_init`'s."""
    return sorted_build(spec_tree, lambda s: s.sds)


def tree_abstract(spec_tree):
    """`tree_init`'s tree as meta tensors: its structure, shapes and dtypes
    and no storage (what a checkpoint restores into)."""
    return sorted_build(spec_tree, lambda s: torch.empty(
        s.shape, dtype=s.torch_dtype, device="meta"))


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array (``np.asarray`` of a JAX array) as a tensor on
    `device` (`resolve_device`), bit for bit; a bfloat16 (``ml_dtypes``)
    array crosses through a two-byte integer view."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_reference(tree, device=None):
    """A tree of numpy arrays (the reference's parameters or state through
    ``np.asarray``) as the same tree of tensors on `device`
    (`resolve_device`: the card unless ``"cpu"`` is named)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_reference(v, device) for v in tree)
    return to_tensor(tree, device)


def count_params(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for s in sorted_leaves(spec_tree))
