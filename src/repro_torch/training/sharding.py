"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

The port of `repro.training.sharding`. Rules:
  embed (d_model)        -> 'data'   (FSDP/ZeRO: params+opt reduce over data)
  vocab / heads / kv_heads / mlp / experts / ssm_inner -> 'model' (TP/EP)
  batch                  -> ('pod','data')
  decode KV cache        -> batch axes; long-context (B==1) -> sequence over
                            'data' (sequence parallelism / flash-decoding)
A dimension falls back to replication when not divisible by its mesh axis
(gemma3's 4 heads on a 16-way model axis).

A partition spec is a plain tuple, one entry a dimension: a mesh-axis
name, a tuple of names, or None (``PartitionSpec('data', None)`` is
``('data', None)``, ``PartitionSpec()`` is ``()``). A `NamedSharding` pairs
it with a `launch.mesh.Mesh`. `local_shape` gives the block one device
holds, `block_slices` where it lies in the whole leaf (the reference's
``NamedSharding.devices_indices_map``), and `place` is the port's
``device_put``. On a mesh of ranks' devices (`process.ProcessDevice`
entries, one rank each) `place` stores this rank's block on its device
(`shard` takes the blocks, `gather` makes them whole again, both for the
sharded LM step of `training.spmd`). On a mesh of one process's devices
it stores each leaf whole where every device is one device (the one card,
or ``[cpu] * k`` in tests), and refuses a real split over distinct
devices: one process never splits a leaf, the ranks of a process mesh
do. `init_blocks` draws seeded weights (`params.tree_init`'s) straight
into a rank's blocks, one leaf at a time a thread.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.distributed import process
from repro_torch.distributed.process import ProcessDevice
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.models.params import (INIT_WORKERS, ParamSpec, init_array,
                                      sorted_build, sorted_leaves,
                                      tree_init)
from repro_torch.optim.optimizers import tree_map, tree_paths

LOGICAL_RULES: dict[str | None, str | None] = {
    "embed": "data",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    None: None,
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A partition spec (a tuple, one entry a dimension) on a mesh."""

    mesh: Mesh
    spec: tuple = ()


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


def _mesh_prod(mesh: Mesh, axes) -> int:
    return math.prod(_axis_size(mesh, a) for a in axes)


def _names(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: tuple[str, ...]):
    """One spec entry over `axes`, as ``PartitionSpec`` normalizes it: a
    lone axis by its name, none as None."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def spec_pspec(mesh: Mesh, spec: ParamSpec) -> tuple:
    out: list = []
    used: set[str] = set()   # a mesh axis may shard at most one dim;
    for dim, logical in zip(spec.shape, spec.axes):  # first dim wins (EP
        mesh_ax = LOGICAL_RULES.get(logical)         # beats TP on experts)
        if mesh_ax is not None and mesh_ax in mesh.axis_names \
                and mesh_ax not in used \
                and dim % _axis_size(mesh, mesh_ax) == 0:
            out.append(mesh_ax)
            used.add(mesh_ax)
        else:
            out.append(None)
    return tuple(out)


def param_shardings(mesh: Mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, spec_pspec(mesh, s)),
                    spec_tree)


def constrain_like_params(tree, spec_tree):
    """`tree` unchanged: a gradient already lands in its parameter's
    layout, whole in one process, on the rank's block under a process
    mesh (`training.spmd.gather_data`'s backward reduce-scatters it
    there)."""
    return tree


def data_pspec(mesh: Mesh, ndim: int, *, batch_dim: int = 0) -> tuple:
    parts: list = [None] * ndim
    parts[batch_dim] = _entry(batch_axes(mesh))
    return tuple(parts)


def data_sharding(mesh: Mesh, ndim: int, *, batch_dim: int = 0):
    return NamedSharding(mesh, data_pspec(mesh, ndim, batch_dim=batch_dim))


def _rebuild(tree, fn, prefix: str = ""):
    """`tree` with each leaf replaced by ``fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def cache_shardings(mesh: Mesh, cfg, cache_tree, *, seq_shard: bool):
    """Decode-cache shardings. seq_shard=True (long-context, batch==1):
    shard the KV sequence dim over 'data' (sequence parallelism); otherwise
    shard batch. kv heads / ssm heads go to 'model' when divisible."""
    bax = batch_axes(mesh)
    bent = _entry(bax)

    def one(name, sds):
        # rightmost-anchored so stacked layouts (+leading n_rep dim) work
        shape = tuple(sds.shape)
        n = len(shape)
        if "'length'" in name or n < 3:
            return NamedSharding(mesh, ())
        parts: list = [None] * n
        if "'k'" in name or "'v'" in name:
            # (..., B, cap, hkv, hd)
            if seq_shard and "data" in mesh.axis_names \
                    and shape[-3] % _axis_size(mesh, "data") == 0:
                parts[-3] = "data"
            elif bax and shape[-4] % _mesh_prod(mesh, bax) == 0:
                parts[-4] = bent
            if shape[-2] % _axis_size(mesh, "model") == 0:
                parts[-2] = "model"
        elif "'ssm'" in name:
            # (..., B, H, N, P)
            if bax and shape[-4] % _mesh_prod(mesh, bax) == 0:
                parts[-4] = bent
            if shape[-3] % _axis_size(mesh, "model") == 0:
                parts[-3] = "model"
        elif "'conv'" in name:
            # (..., B, K-1, conv_dim)
            if bax and shape[-3] % _mesh_prod(mesh, bax) == 0:
                parts[-3] = bent
            if shape[-1] % _axis_size(mesh, "model") == 0:
                parts[-1] = "model"
        return NamedSharding(mesh, tuple(parts))

    return _rebuild(cache_tree, one)


def opt_state_shardings(mesh: Mesh, spec_tree, opt_state_shapes):
    """Optimizer state inherits the param sharding where shapes match;
    factored Adafactor rows/cols inherit the matching prefix; scalars
    replicate. Parameter names are tried in the reference's (sorted)
    order, the first that matches wins."""
    param_shards = {name: (s.shape, spec_pspec(mesh, s))
                    for name, s in tree_paths(spec_tree)}

    def one(name, sds):
        shape = tuple(sds.shape)
        for pname, (pshape, pspec) in param_shards.items():
            if pname in name:
                if shape == pshape:
                    return NamedSharding(mesh, pspec)
                if shape == pshape[:-1]:   # adafactor row stats
                    return NamedSharding(mesh, pspec[:-1])
                if len(pshape) >= 2 and shape == pshape[:-2] + pshape[-1:]:
                    return NamedSharding(mesh, pspec[:-2] + pspec[-1:])
        return NamedSharding(mesh, ())

    return _rebuild(opt_state_shapes, one)


def local_shape(shape, spec: tuple, mesh: Mesh) -> tuple[int, ...]:
    """The block of a `shape` leaf that one device of `mesh` holds under
    `spec` (a dimension split n ways holds ceil(dim / n))."""
    out = list(shape)
    for i, entry in enumerate(spec):
        n = _mesh_prod(mesh, _names(entry))
        out[i] = -(-out[i] // n)
    return tuple(out)


def local_bytes(tree, shardings) -> int:
    """Bytes one device holds of a tree of tensors or `TensorSpec`s under
    the matching tree of `NamedSharding`s."""
    pairs = dict(tree_paths(shardings))
    total = 0
    for name, leaf in tree_paths(tree):
        sh = pairs[name]
        total += (math.prod(local_shape(leaf.shape, sh.spec, sh.mesh))
                  * leaf.dtype.itemsize)
    return total


def is_process_mesh(mesh: Mesh) -> bool:
    """Whether `mesh`'s entries are ranks' devices (`ProcessDevice`)."""
    return isinstance(mesh.devices.flat[0], ProcessDevice)


def mesh_position(mesh: Mesh) -> tuple[int, ...]:
    """This rank's position in a process mesh (it must hold one entry)."""
    me = process.process_index()
    hits = [idx for idx, d in np.ndenumerate(mesh.devices)
            if d.process_index == me]
    if len(hits) != 1:
        raise ValueError(f"rank {me} holds {len(hits)} entries of {mesh}; "
                         "a process mesh gives each rank one")
    return tuple(int(i) for i in hits[0])


def block_slices(shape, spec: tuple, mesh: Mesh, position) -> tuple:
    """The slices of a `shape` leaf that the device at mesh `position`
    holds under `spec`: a dim split over axes takes their coordinates
    row-major, blocks of `local_shape`'s size (the reference's
    ``devices_indices_map``)."""
    out = []
    for i, dim in enumerate(shape):
        axes = _names(spec[i]) if i < len(spec) else ()
        n, c = 1, 0
        for a in axes:
            k = mesh.axis_names.index(a)
            n, c = n * mesh.devices.shape[k], c * mesh.devices.shape[k] \
                + position[k]
        if n == 1:
            out.append(slice(None))
        else:
            b = -(-dim // n)
            out.append(slice(c * b, min((c + 1) * b, dim)))
    return tuple(out)


def shard(tree, shardings, position=None):
    """Each tensor of `tree` cut to the block of `position` (default:
    this rank's, `mesh_position`) under its `NamedSharding` (a
    same-structured tree), on the tensor's device, in storage of its
    own."""
    def one(t, sh):
        pos = mesh_position(sh.mesh) if position is None else position
        block = t[block_slices(t.shape, sh.spec, sh.mesh, pos)]
        return block.clone(memory_format=torch.contiguous_format)

    return tree_map(one, tree, shardings)


def gather(tree, shardings):
    """Blocks made whole: every rank's block of each leaf all-gathered
    over the axes that split it, on this rank's device (collective on a
    process mesh; the tree itself elsewhere)."""
    from repro_torch.training import spmd

    def one(t, sh):
        if not is_process_mesh(sh.mesh):
            return t
        lay = spmd.layout_of(sh.mesh)
        for i, entry in enumerate(sh.spec):
            for a in reversed(_names(entry)):
                t = spmd.all_gather(lay, a, t, i, count=False)
        return t

    return tree_map(one, tree, shardings)


def device_for(sh: NamedSharding) -> torch.device:
    """The device `place` stores a leaf of sharding `sh` on: on a process
    mesh this rank's device; else the mesh's one device where it repeats
    one, else its first device for a leaf no axis of size above 1 splits
    (the single-controller step reads it there). A real split over
    distinct devices of one process raises `NotImplementedError`: it is
    never replaced by a silent replica."""
    if is_process_mesh(sh.mesh):
        return sh.mesh.devices[mesh_position(sh.mesh)].device
    devices = set(sh.mesh.devices.flat)
    if len(devices) == 1:
        return next(iter(devices))
    split = [a for entry in sh.spec for a in _names(entry)
             if _axis_size(sh.mesh, a) > 1]
    if split:
        raise NotImplementedError(
            f"a leaf split over mesh axes {split} of distinct devices "
            f"{sorted(map(str, devices))}: one process holds each leaf "
            "whole on one device; a split runs one rank per device, on a "
            "process mesh (launch.mesh.rank_mesh, training.spmd)")
    return sh.mesh.devices.flat[0]


def place(tree, shardings):
    """The port's ``jax.device_put(tree, shardings)`` (a same-structured
    tree of `NamedSharding`s): on a process mesh this rank's block of each
    tensor (`shard`) on its device; elsewhere each tensor whole on
    `device_for` its sharding."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    if is_process_mesh(shardings.mesh):
        return shard(tree, shardings).to(device_for(shardings))
    return tree.to(device_for(shardings))


def init_blocks(spec_tree, seed: int, shardings):
    """``place(params.tree_init(spec_tree, seed, "cpu"), shardings)``,
    bitwise. On a mesh of ranks each of a few threads draws a leaf
    (`params.init_array`), places this rank's block of it and frees the
    rest before it draws the next, so a rank's host holds about one leaf
    a thread beside its blocks, not the whole tree."""
    sh = sorted_leaves(shardings)
    if not is_process_mesh(sh[0].mesh):
        return place(tree_init(spec_tree, seed, "cpu"), shardings)
    specs = sorted_leaves(spec_tree)

    def one(i):
        whole = torch.from_numpy(init_array(specs[i], seed, i))
        return place(whole.to(specs[i].torch_dtype), sh[i])

    with ThreadPoolExecutor(max_workers=INIT_WORKERS) as pool:
        blocks = pool.map(one, range(len(specs)))
        return sorted_build(spec_tree, lambda _: next(blocks))
