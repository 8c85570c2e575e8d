"""Explicit collectives of the sharded LM step: what GSPMD inserts for the
reference, written out in the Megatron/ZeRO pattern.

Under a mesh whose entries are ranks' devices (`launch.mesh.rank_mesh`,
`elastic.build_mesh` under a process group), each rank holds the blocks
of the train state that `training.sharding` gives its mesh position
(`sharding.place`), and the model code calls these functions where the
reference's layouts imply a collective:

- `gather_data` (FSDP, ``embed -> 'data'``): a leaf's 'data' dim is
  all-gathered in the forward, inside each block's checkpointed function
  (so the backward re-gathers and a rank holds one block's full weights
  at a time); its gradient is reduce-scattered back onto the block. A
  leaf no 'data' dim splits has its gradient all-reduced over 'data'
  instead. The loss each rank differentiates is its rows' mean over the
  number of batch shards, so these sums give the global batch mean's
  gradient.
- `enter_model` / `reduce_model` (tensor parallelism over 'model'):
  identity forward with an all-reduce of the gradient, and an all-reduce
  forward with an identity backward. Column-parallel products (the
  attention's q/k/v, the MLP's up-projections, the vocab head) take their
  input through `enter_model`; row-parallel ones (the attention's
  out-projection, the MLP's down-projection) end in `reduce_model`. A
  leaf replicated over 'model' that a rank uses on its own heads only
  (``q_norm``, ``k_norm``, kv projections whose heads do not split) goes
  through `enter_model` too, so its gradient is summed over 'model'.
- `vocab_lookup`, `vocab_cross_entropy`, `vocab_argmax`: the embedding,
  the loss and greedy decoding on a rank's vocab rows, with all-reduces
  of the rows' partial results (max and sum-exp for the loss).
- `norm_sq_sum`: the gradients' global squared norm, each element
  counted once (a leaf's block counts on the ranks at coordinate 0 of
  every axis that does not split it), all-reduced over the mesh.
- `gather_model` (Mamba2's conv leaves and conv state, whose 'model'
  blocks do not follow the heads): an all-gather over 'model' whose
  gradient is reduce-scattered back onto the block; `sum_over_model`
  (the gated norm's sum of squares over a split ``d_inner``): an
  all-reduce whose gradient is all-reduced too; `once_over_model` (the
  MoE load-balance loss every model rank computes whole): the gradient
  divided by the 'model' size, so that its sum over 'model' counts once.
- `batch_counts` (MoE routing in the global token order): one all-gather
  of each batch shard's per-expert counts over the batch axes.
- `seq_softmax` / `seq_sum` (batch-1 decode whose KV slots split over
  'data', `decode_layout`): the flash-decoding combine of the ranks'
  softmax partials.
- `BlockMeans` (Adafactor on blocks): a mean over dimensions a mesh axis
  may split, as a sum all-reduced over exactly those axes over the
  global count, and the relayout of a moment whose stored layout is not
  the one its computation gives.

Every collective of a rank is counted in `COUNTER` by kind, in the
reference's convention (`repro.launch.roofline.collective_bytes`: an
operand's bytes; an all-gather counts its input block, a reduce-scatter
its whole input). Under gloo a CUDA tensor is staged through a pinned
host buffer (`COUNTER.stage_s`; the backend's own time is `wire_s`), and
a reduce-scatter runs as an all-reduce of the same operand and a slice;
under NCCL device buffers go straight to the backend. A `Layout` over an
abstract mesh (``meta`` devices, `launch.mesh.abstract_mesh`) is
virtual: its collectives move nothing and only count, which is how the
dry-run prices an LM cell's collective term (`launch.dryrun`) with the
same calls.

Every rank issues the same collectives in the same order (the backward
and its re-gathers included), since every rank runs the same program on
blocks of equal shapes. Every block and optimizer the reference splits is
split: attention and MLPs, Mamba2 over its heads, mixture-of-experts
over its experts (or their hidden columns), Adafactor's factored
moments, and the KV sequence of a batch-1 decode over 'data'.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import process
from repro_torch.distributed.process import ProcessDevice
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.training import sharding as shd

KINDS = ("all-gather", "reduce-scatter", "all-reduce")


@dataclasses.dataclass
class Counter:
    """A rank's collectives since the last `reset`: operand bytes and
    calls by kind, the seconds inside the backend's calls (`wire_s`) and
    copying CUDA tensors to and from pinned host buffers (`stage_s`)."""

    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    wire_s: float = 0.0
    stage_s: float = 0.0

    def reset(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)
        self.calls = dict.fromkeys(KINDS, 0)
        self.wire_s = self.stage_s = 0.0

    def add(self, kind: str, x: torch.Tensor) -> None:
        self.bytes[kind] += x.numel() * x.element_size()
        self.calls[kind] += 1

    def snapshot(self) -> dict:
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "wire_s": self.wire_s, "stage_s": self.stage_s}


COUNTER = Counter()


@contextlib.contextmanager
def counting():
    """A fresh `Counter` in place of `COUNTER` for the block (the one it
    yields), the previous one restored after."""
    global COUNTER
    before, COUNTER = COUNTER, Counter()
    try:
        yield COUNTER
    finally:
        COUNTER = before


class Layout:
    """This rank's place on a mesh: its coordinate and group along each
    axis (and along the batch axes), and how tensors cross (the process
    group's backend, or ``"virtual"``: count only). `seq_len`, set by
    `decode_layout` only, is the KV cache's global length under a batch-1
    decode step (its rows replicated, its KV slots split over 'data')."""

    def __init__(self, mesh: Mesh, groups: dict, transport: str):
        self.mesh = mesh
        self.groups = groups
        self.transport = transport
        self.batch = batch_axes(mesh)
        self.seq_len = 0

    @property
    def split(self) -> bool:
        """Whether any axis of the mesh is above 1."""
        return self.mesh.devices.size > 1

    def size(self, axes) -> int:
        return self._group(axes).size

    def coord(self, axes) -> int:
        return self._group(axes).index

    def _group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes:
            return process.AxisGroup((0,), 0)
        return self.groups[axes]


def _virtual_groups(mesh: Mesh, position: tuple) -> dict:
    """Groups that move nothing: each axis combination's size and this
    position's coordinate along it."""
    names = tuple(mesh.axis_names)
    out = {}
    for combo in process.axis_combos(names):
        sizes = tuple(mesh.shape[n] for n in combo)
        index = 0
        for n, s in zip(combo, sizes):
            index = index * s + position[names.index(n)]
        out[combo] = process.AxisGroup(tuple(range(math.prod(sizes))),
                                       index)
    return out


@functools.lru_cache(maxsize=16)
def layout_of(mesh: Mesh) -> Layout | None:
    """The `Layout` of this rank on `mesh`: over `ProcessDevice`s, its
    groups (`process.axis_group`); over ``meta`` devices, a virtual place
    at the mesh's first position; None for a mesh of local devices, on
    which one process holds every leaf whole."""
    first = mesh.devices.flat[0]
    if isinstance(first, ProcessDevice):
        groups = {c: process.axis_group(mesh, c)
                  for c in process.axis_combos(mesh.axis_names)}
        return Layout(mesh, groups, process.backend() or "gloo")
    if all(torch.device(d).type == "meta" for d in mesh.devices.flat):
        return Layout(mesh, _virtual_groups(mesh, (0,) * mesh.devices.ndim),
                      "virtual")
    return None


def decode_layout(lay: Layout, seq_len: int) -> Layout:
    """`lay` for a batch-1 decode step against a `seq_len`-slot cache
    (`sharding.cache_shardings(seq_shard=True)`): the one row is every
    rank's, and a KV cache whose slots 'data' divides holds this rank's
    contiguous block of them."""
    out = copy.copy(lay)
    out.seq_len = seq_len
    return out


_ACTIVE: list = [None]


def active() -> Layout | None:
    """The layout of the step being run, or None (one process, leaves
    whole)."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use(layout: Layout | None):
    """Run the model's code under `layout` (None: as one process)."""
    before = _ACTIVE[0]
    _ACTIVE[0] = layout
    try:
        yield layout
    finally:
        _ACTIVE[0] = before


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _pinned(lay: Layout, x: torch.Tensor) -> bool:
    """Whether `x` crosses through pinned host memory (CUDA under gloo)."""
    return lay.transport == "gloo" and x.is_cuda


def _staged(lay: Layout, x: torch.Tensor, copy: bool) -> torch.Tensor:
    """A contiguous buffer of `x` the backend can move: pinned host
    memory for a CUDA tensor under gloo, else `x` contiguous (a copy of
    its own where `copy`: the backend reduces into it)."""
    if _pinned(lay, x):
        torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        COUNTER.stage_s += time.perf_counter() - t0
        return buf
    x = x.contiguous()
    return x.clone() if copy else x


def _landed(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`buf` on `like`'s device, in storage of its own."""
    if buf.device == like.device:
        return buf.clone(memory_format=torch.contiguous_format)
    t0 = time.perf_counter()
    out = buf.to(like.device)
    COUNTER.stage_s += time.perf_counter() - t0
    return out


def _wire(fn):
    t0 = time.perf_counter()
    fn()
    COUNTER.wire_s += time.perf_counter() - t0


def all_gather(lay: Layout, axes, x: torch.Tensor, dim: int,
               count: bool = True) -> torch.Tensor:
    """The members' `x` along `axes`, concatenated along `dim` in
    coordinate order."""
    g = lay._group(axes)
    if g.size == 1:
        return x
    if count:
        COUNTER.add("all-gather", x)
    if lay.transport == "virtual":
        shape = list(x.shape)
        shape[dim] *= g.size
        return x.new_empty(shape)
    buf = _staged(lay, x, copy=False)
    parts = [torch.empty(buf.shape, dtype=buf.dtype,
                         pin_memory=_pinned(lay, x))
             for _ in range(g.size)]
    _wire(lambda: dist.all_gather(parts, buf, group=g.group))
    order = [dist.get_group_rank(g.group, r) for r in g.ranks]
    if _pinned(lay, x):
        t0 = time.perf_counter()
        parts = [parts[k].to(x.device) for k in order]
        COUNTER.stage_s += time.perf_counter() - t0
        return torch.cat(parts, dim=dim)
    return torch.cat([parts[k] for k in order], dim=dim)


def all_reduce(lay: Layout, axes, x: torch.Tensor, op: str = "sum",
               count: bool = True) -> torch.Tensor:
    """The sum (or max) of the members' `x` along `axes`, a new tensor."""
    g = lay._group(axes)
    if g.size == 1:
        return x
    if count:
        COUNTER.add("all-reduce", x)
    if lay.transport == "virtual":
        return x.new_empty(x.shape)
    buf = _staged(lay, x, copy=True)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    _wire(lambda: dist.all_reduce(buf, op=red, group=g.group))
    return buf if buf.device == x.device else _landed(buf, x)


def all_reduce_world(lay: Layout, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over every rank of the mesh."""
    for axes in lay.mesh.axis_names:
        x = all_reduce(lay, axes, x)
    return x


def reduce_scatter(lay: Layout, axes, x: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the members' summed `x`."""
    g = lay._group(axes)
    if g.size == 1:
        return x
    COUNTER.add("reduce-scatter", x)
    n = x.shape[dim] // g.size
    if lay.transport == "virtual":
        return x.new_empty(x.shape[:dim] + (n,) + x.shape[dim + 1:])
    rows = x.movedim(dim, 0)         # the split dim first: blocks contiguous
    if lay.transport == "nccl":
        chunks = rows.reshape(g.size, n, *rows.shape[1:])
        order = [dist.get_group_rank(g.group, r) for r in g.ranks]
        inp = torch.empty_like(chunks)
        for coord, grank in enumerate(order):
            inp[grank] = chunks[coord]
        out = torch.empty_like(chunks[0])
        _wire(lambda: dist.reduce_scatter_tensor(out, inp, group=g.group))
    else:
        buf = _staged(lay, rows, copy=True)
        _wire(lambda: dist.all_reduce(buf, group=g.group))
        out = _landed(buf.narrow(0, g.index * n, n), x)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------

class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, dim):
        ctx.lay, ctx.dim = lay, dim
        if dim is None:
            return x.view_as(x)
        return all_gather(lay, "data", x, dim)

    @staticmethod
    def backward(ctx, g):
        lay, dim = ctx.lay, ctx.dim
        if dim is None:
            g = all_reduce(lay, "data", g)
        else:
            g = reduce_scatter(lay, "data", g, dim)
        if "pod" in lay.mesh.axis_names:
            g = all_reduce(lay, "pod", g)
        return g, None, None


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        ctx.lay = lay
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.lay, "model", g), None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay):
        return all_reduce(lay, "model", x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lay, dim):
        ctx.lay, ctx.dim = lay, dim
        return all_gather(lay, "model", x, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(ctx.lay, "model", g, ctx.dim), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _batch_size(lay: Layout) -> int:
    return lay.size(lay.batch)


def gather_data(x: torch.Tensor, spec) -> torch.Tensor:
    """Leaf block `x` of `spec` (a `ParamSpec`) whole along its 'data'
    dim; its gradient summed over the batch shards onto the block."""
    lay = active()
    if lay is None or _batch_size(lay) == 1:
        return x
    pspec = shd.spec_pspec(lay.mesh, spec)
    dims = [i for i, e in enumerate(pspec) if "data" in shd._names(e)]
    return _GatherData.apply(x, lay, dims[0] if dims else None)


def gather_params(tree, specs):
    """`gather_data` over a tree of blocks and its same-structured tree of
    `ParamSpec`s (one block's parameters)."""
    lay = active()
    if lay is None or _batch_size(lay) == 1:
        return tree
    return tree_map(gather_data, tree, specs)


def model_coord() -> int:
    lay = active()
    return 0 if lay is None else lay.coord("model")


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the gradient is all-reduced over 'model'."""
    lay = active()
    if lay is None or lay.size("model") == 1:
        return x
    return _EnterModel.apply(x, lay)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the 'model' ranks' partial `x`; identity backward."""
    lay = active()
    if lay is None or lay.size("model") == 1:
        return x
    return _ReduceModel.apply(x, lay)


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x`, this rank's block along 'model' of dim `dim`, whole (the
    ranks' blocks in coordinate order); its gradient summed over 'model'
    and cut back to the block (a reduce-scatter)."""
    lay = active()
    if lay is None or lay.size("model") == 1:
        return x
    return _GatherModel.apply(x, lay, dim % x.ndim)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the 'model' ranks' partial `x` where each rank then uses
    it on its own share: the gradient is summed over 'model' as well."""
    return enter_model(reduce_model(x))


def once_over_model(x: torch.Tensor) -> torch.Tensor:
    """Identity; the gradient divided by the 'model' size. For a term
    every model rank computes whole from inputs that enter 'model'
    (`enter_model` sums their gradients): summed, it counts once."""
    lay = active()
    if lay is None or lay.size("model") == 1:
        return x
    return _ScaleGrad.apply(x, 1.0 / lay.size("model"))


# ---------------------------------------------------------------------------
# the global token order, the KV sequence over 'data'
# ---------------------------------------------------------------------------

def row_shards() -> int:
    """How many shards the global batch's rows are split into: the batch
    axes' size; 1 in one process and under a batch-1 decode step, whose
    row every rank holds."""
    lay = active()
    if lay is None or lay.seq_len:
        return 1
    return _batch_size(lay)


def batch_counts(counts: torch.Tensor):
    """``(before, total)`` of this batch shard's per-expert `counts` (E,):
    the counts of the shards before it in coordinate order over the batch
    axes (the order of the global rows, `local_rows`) and the global
    counts, from one all-gather. In one process: zeros and `counts`."""
    if row_shards() == 1:
        return torch.zeros_like(counts), counts
    lay = active()
    every = all_gather(lay, lay.batch, counts[None], 0)
    return every[:lay.coord(lay.batch)].sum(0), every.sum(0)


def seq_block(whole: int, cap: int) -> int:
    """The first global slot of this rank's `cap` slots of a `whole`-slot
    KV cache: under `decode_layout` a cache split over 'data' holds a
    contiguous block a rank, else every slot (0)."""
    if cap == whole:
        return 0
    return active().coord("data") * cap


def seq_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax weights over the last dim of this rank's slots `logits`
    (float32), normalized over every rank's slots along 'data': the
    maximum all-reduced (max), then the sum of exponentials."""
    lay = active()
    m = torch.amax(logits, dim=-1, keepdim=True)
    m = all_reduce(lay, "data", m, op="max")
    e = torch.exp(logits - m)
    return e / all_reduce(lay, "data", torch.sum(e, dim=-1, keepdim=True))


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over 'data' of the ranks' partial attention outputs."""
    return all_reduce(active(), "data", x)


# ---------------------------------------------------------------------------
# the vocab split
# ---------------------------------------------------------------------------

def vocab_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed_full[tokens]`` from this rank's vocab rows `embed`: rows
    outside the block give zeros, and the ranks' lookups are summed."""
    off = model_coord() * embed.shape[0]
    tok = tokens.long() - off
    hit = (tok >= 0) & (tok < embed.shape[0])
    rows = embed[torch.where(hit, tok, 0)]
    return reduce_model(torch.where(hit[..., None], rows,
                                    torch.zeros((), dtype=rows.dtype,
                                                device=rows.device)))


def vocab_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of local vocab columns `logits` (float32): the
    max and the sum of exponentials all-reduced over 'model', the gold
    logit taken by the rank whose columns hold the label."""
    lay = active()
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    m = all_reduce(lay, "model", m, op="max")
    se = reduce_model(torch.sum(torch.exp(lf - m), dim=-1))
    lse = torch.log(se) + m[..., 0]
    off = model_coord() * lf.shape[-1]
    vocab_iota = off + torch.arange(lf.shape[-1], dtype=torch.int32,
                                    device=lf.device)
    gold = reduce_model(torch.sum(torch.where(
        vocab_iota == labels[..., None], lf, 0.0), dim=-1))
    return torch.mean(lse - gold)


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """The global argmax over the last dim of local vocab columns
    `logits`, the first index among equal maxima, as ``torch.argmax``."""
    lay = active()
    best, idx = torch.max(logits.float(), dim=-1)
    idx = idx + model_coord() * logits.shape[-1]
    top = all_reduce(lay, "model", best, op="max")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(best == top, idx, torch.full_like(idx, big))
    return -all_reduce(lay, "model", -cand, op="max")


# ---------------------------------------------------------------------------
# batch rows, metrics, the global norm
# ---------------------------------------------------------------------------

def local_rows(lay: Layout, batch: dict) -> dict:
    """This rank's rows of a global batch (M-RoPE positions along dim
    1), as ``data_sharding`` splits them over the batch axes."""
    n, c = lay.size(lay.batch), lay.coord(lay.batch)
    if n == 1:
        return batch
    out = {}
    for key, v in batch.items():
        dim = 1 if key == "positions" and v.ndim == 3 else 0
        if v.shape[dim] % n:
            raise ValueError(f"batch entry {key!r} of {v.shape[dim]} rows "
                             f"does not split over {n} batch shards")
        rows = v.shape[dim] // n
        out[key] = v.narrow(dim, c * rows, rows)
    return out


def batch_mean(values: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each rank's 0-d `values` averaged over the batch shards (one
    all-reduce)."""
    lay = active()
    if lay is None or _batch_size(lay) == 1:
        return values
    n = _batch_size(lay)
    total = all_reduce(lay, lay.batch, torch.stack(values))
    return [total[i] / n for i in range(len(values))]


def owned(tree, shardings) -> list[bool]:
    """Per leaf of `tree` (in `tree_leaves` order) whether this rank's
    block counts toward the global norm: its coordinate is 0 along every
    mesh axis that does not split the leaf (its `NamedSharding` in the
    same-structured `shardings`)."""
    lay = active()

    def one(_, sh):
        used = {a for e in sh.spec for a in shd._names(e)}
        return all(lay.coord(a) == 0 for a in lay.mesh.axis_names
                   if a not in used)

    return tree_leaves(tree_map(one, tree, shardings))


def norm_sq_sum(tree, shardings):
    """``sq_sum`` for `optim.clip_by_global_norm` of gradients shaped as
    `tree`: the sum over the leaves this rank owns (`owned`) of their
    squared norms, all-reduced over the mesh."""
    lay = active()
    mask = owned(tree, shardings)

    def sq_sum(sqs):
        mine = [s for s, keep in zip(sqs, mask) if keep]
        total = sum(mine) if mine else torch.zeros(
            (), dtype=torch.float32, device=sqs[0].device)
        return all_reduce_world(lay, total)

    return sq_sum


# ---------------------------------------------------------------------------
# Adafactor on blocks
# ---------------------------------------------------------------------------

def _split_axes(lay: Layout, spec: tuple, dims) -> list[str]:
    """The mesh axes above 1 that split any of `dims` under `spec`."""
    return [a for d in dims if d < len(spec) for a in shd._names(spec[d])
            if lay.size(a) > 1]


def relayout(lay: Layout, x: torch.Tensor, src: tuple,
             dst: tuple) -> torch.Tensor:
    """A block of layout `src` (a partition spec) as this rank's block of
    the same tensor under `dst`: each dim whose axes differ gathered
    whole over `src`'s axes, then cut to `dst`'s coordinate."""
    for i, (a, b) in enumerate(zip(src, dst)):
        if shd._names(a) == shd._names(b):
            continue
        for ax in reversed(shd._names(a)):
            x = all_gather(lay, ax, x, i)
        n, c = 1, 0
        for ax in shd._names(b):
            n, c = n * lay.size(ax), c * lay.size(ax) + lay.coord(ax)
        if n > 1:
            x = x.narrow(i, c * (x.shape[i] // n), x.shape[i] // n)
    return x


class BlockMeans:
    """Means over a parameter leaf's block that equal the global leaf's:
    the block's sum all-reduced over exactly the mesh axes that split the
    reduced dims (from the leaf's partition spec), over the global count;
    a plain mean where no axis splits them. `vc_in` / `vc_out` move
    Adafactor's column moment between the layout its computation gives
    (the parameter's spec without dim -2) and the one it is stored in
    (`sharding.opt_state_shardings`, which the reference matches by shape
    and so gives a square leaf's column moment its row layout)."""

    def __init__(self, lay: Layout, shape: tuple, spec: tuple,
                 vc_spec: tuple | None):
        self.lay, self.shape, self.spec = lay, tuple(shape), tuple(spec)
        self.vc_natural = self.spec[:-2] + self.spec[-1:]
        self.vc_stored = vc_spec

    @property
    def vc_block(self) -> tuple:
        """The shape of this rank's stored block of the column moment."""
        return shd.local_shape(self.shape[:-2] + self.shape[-1:],
                               self.vc_stored, self.lay.mesh)

    def mean(self, x: torch.Tensor, dims, pdims, keepdim: bool = False):
        """The mean of block `x` over its `dims` (None: all), which are
        the parameter's dims `pdims`."""
        axes = _split_axes(self.lay, self.spec, pdims)
        if not axes:
            if dims is None:
                return torch.mean(x)
            return torch.mean(x, dim=dims, keepdim=keepdim)
        s = torch.sum(x) if dims is None else torch.sum(
            x, dim=dims, keepdim=keepdim)
        for a in axes:
            s = all_reduce(self.lay, a, s)
        return s / math.prod(self.shape[d] for d in pdims)

    def vc_in(self, vc: torch.Tensor) -> torch.Tensor:
        return relayout(self.lay, vc, self.vc_stored, self.vc_natural)

    def vc_out(self, vc: torch.Tensor) -> torch.Tensor:
        return relayout(self.lay, vc, self.vc_natural, self.vc_stored)


def block_means(lay: Layout, params, specs, shardings,
                opt_shardings) -> list:
    """A `BlockMeans` on `lay` per leaf of `params` (blocks, in
    `tree_leaves` order) from the same-structured trees of `ParamSpec`s
    (global shapes), their `NamedSharding`s, and the optimizer state's
    shardings (Adafactor's ``{"vr", "vc"}`` or ``{"v"}`` a leaf)."""
    def one(_, spec, sh, opt_sh):
        vc = opt_sh.get("vc")
        return BlockMeans(lay, spec.shape, sh.spec,
                          None if vc is None else vc.spec)

    return tree_leaves(tree_map(one, params, specs, shardings,
                                opt_shardings))
