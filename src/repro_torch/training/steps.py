"""The LM train, serve and prefill steps, the generic fit step, and the
dry-run's abstract inputs.

The port of `repro.training.steps`. Every step runs eagerly on the
device its tensors are on. Gradients come from `torch.autograd.grad` on
leaf copies of the parameters; updates run without autograd. The train
state is the reference's ``{"params", "opt", "step"}``, which
`distributed.checkpoint` saves as it saves the reference's.

Given a mesh of ranks' devices (``mesh=``), the LM steps are the sharded
step of `training.spmd`: the state holds this rank's blocks
(`sharding.place`), the train and prefill steps take the rank's rows of
the global batch, gradients land on the blocks (and accumulate there),
the loss is the global batch mean and the gradients' norm the global one.
Microbatch i is the reference's, global rows [i B/k, (i+1) B/k), of
which the rank takes its rows, so a mixture-of-experts layer routes the
same tokens together. Adafactor's means run on the blocks
(`spmd.BlockMeans`). The serve step works on the rank's rows and cache
blocks; `make_decoder` lays out a decode once, the batch-1 decode whose
cache splits its KV slots over 'data' included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import lm
from repro_torch.models.params import TensorSpec, tree_abstract, tree_sds
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm, is_moments,
                                          tree_leaves, tree_map,
                                          tree_unflatten)
from repro_torch.training import sharding as shd
from repro_torch.training import spmd

__all__ = ["make_train_step", "make_fit_step", "make_serve_step",
           "make_decoder", "Decoder", "long_context", "make_prefill_step",
           "make_optimizer", "train_state_specs", "abstract_inputs",
           "input_specs"]


def _microbatch(batch: dict, i: int, k: int, b: int) -> dict:
    """Microbatch `i` of `k`: rows of every entry, and of the M-RoPE
    ``(3, B, S)`` positions along their batch dim (dim 1)."""
    out = {}
    for key, v in batch.items():
        if key == "positions" and v.ndim == 3:
            n = v.shape[1] // k
            out[key] = v[:, i * n:(i + 1) * n]
        else:
            out[key] = v[i * (b // k):(i + 1) * (b // k)]
    return out


def make_train_step(cfg: ArchConfig, *, lr=None, aux_weight: float = 0.01,
                    chunk: int = 2048, accum: int = 1, mesh=None):
    """``(opt, train_step)``; ``train_step(state, batch) -> (new_state,
    metrics)``.

    accum > 1: microbatch gradient accumulation (when it divides the
    batch), activation peak / accum. Each microbatch's gradients are cast
    to ``cfg.grad_dtype`` and divided by the count before they are summed;
    the sum is clipped to a global norm of 1. Metrics (``ce``, ``aux``,
    ``loss``, ``grad_norm``) are detached 0-d tensors: the loss and its
    parts are the microbatch means, the norm is before clipping. The
    parameter layout (unrolled or stacked) is read from the tree.

    `mesh`, a mesh of ranks' devices (or an abstract one, whose
    collectives only count): the state holds this rank's blocks, the
    batch is global and the step takes its rows of each global
    microbatch, and the metrics are global. The returned `opt`'s
    ``init`` on the blocks gives the state in the reference's layouts.
    """
    opt = make_optimizer(cfg.optimizer, lr)
    acc_dtype = getattr(torch, cfg.grad_dtype)
    layout = spmd.layout_of(mesh) if mesh is not None else None
    norm_sq, means = {}, {}

    def sq_sum(params):
        """The sharded global norm's squared sum for `params`' layout."""
        stacked = "blocks" not in params
        if stacked not in norm_sq:
            norm_sq[stacked] = spmd.norm_sq_sum(params, shd.param_shardings(
                mesh, lm.param_specs(cfg, stacked=stacked)))
        return norm_sq[stacked]

    def block_means(params) -> dict:
        """Adafactor's means on `params`' blocks (a split mesh only: one
        block a leaf takes the one-process means)."""
        if layout is None or not layout.split or cfg.optimizer == "adamw":
            return {}
        stacked = "blocks" not in params
        if stacked not in means:
            specs = lm.param_specs(cfg, stacked=stacked)
            opt_sds = train_state_specs(cfg, stacked=stacked)[0]["opt"]
            means[stacked] = spmd.block_means(
                layout, params, specs, shd.param_shardings(mesh, specs),
                shd.opt_state_shardings(mesh, specs, opt_sds))
        return {"means": means[stacked]}

    def init(params):
        """`opt.init` on this rank's blocks, each column moment in its
        stored layout (`BlockMeans.vc_block`), which a square leaf's
        shapes do not give."""
        state = opt.init(params)
        for s, m in zip(tree_leaves(state, is_moments),
                        block_means(params).get("means", ())):
            if "vc" in s:
                s["vc"] = s["vc"].new_zeros(m.vc_block)
        return state

    def train_step(state, batch):
        with spmd.use(layout):
            return step_on(state, batch)

    def step_on(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        shards = 1 if layout is None else layout.size(layout.batch)
        # the global batch size of the first entry in JAX's (sorted) order
        b = batch[sorted(batch)[0]].shape[0]
        k = accum if b % accum == 0 else 1
        loss, metrics, grads = 0.0, None, None
        for i in range(k):
            mb = _microbatch(batch, i, k, b)
            if layout is not None:      # this rank's rows of microbatch i
                mb = spmd.local_rows(layout, mb)
            ls, mt = lm.loss_fn(cfg, live, mb, aux_weight=aux_weight,
                                chunk=chunk)
            # a rank's mean over its rows, over the shards: the summed
            # gradients are the global batch mean's
            g = torch.autograd.grad(ls / shards if shards > 1 else ls,
                                    leaves, allow_unused=True,
                                    materialize_grads=True)
            gf = [x.to(acc_dtype) / k for x in g]
            del g
            grads = gf if grads is None else [
                a + c for a, c in zip(grads, gf)]
            loss = loss + ls.detach() / k
            mt = {n: v.detach() / k for n, v in mt.items()}
            metrics = mt if metrics is None else {
                n: metrics[n] + mt[n] for n in mt}
        if shards > 1:
            names = sorted(metrics)
            loss, *vals = spmd.batch_mean([loss] + [metrics[n]
                                                    for n in names])
            metrics = dict(zip(names, vals))
        grads, gnorm = clip_by_global_norm(
            tree_unflatten(params, grads), 1.0,
            None if layout is None else sq_sum(params))
        updates, new_opt = opt.update(grads, opt_state, params, step,
                                      **block_means(params))
        del grads
        new_params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                metrics)

    return Optimizer(init, opt.update), train_step


def make_fit_step(opt, loss_fn, *, clip: float = 1.0):
    """Single-program fit step for non-LM objectives.

    `loss_fn(params, *args) -> (loss, aux_dict)`; `opt` an
    `repro_torch.optim.Optimizer`. Returns ``fit_step(state, *args) ->
    (new_state, metrics)`` over the reference's ``{"params", "opt",
    "step"}`` state. The loss and the gradients come from
    `torch.autograd.grad` on leaf copies of the parameters; the update runs
    without autograd. Metrics are the aux values, the loss before the
    update and the gradients' global norm before clipping, all detached.
    This is what `launch.fit` drives: the loss closes over
    `ops.mwd_diff` and `params` is the coefficient field being recovered.
    """
    def fit_step(state, *args):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        grads, gnorm = clip_by_global_norm(grads, clip)
        updates, new_opt = opt.update(grads, opt_state, params, step)
        new_params = apply_updates(params, updates)
        metrics = dict(tree_map(torch.Tensor.detach, aux),
                       loss=loss.detach(), grad_norm=gnorm)
        return ({"params": new_params, "opt": new_opt, "step": step + 1},
                metrics)

    return fit_step


def make_serve_step(cfg: ArchConfig):
    """``serve_step(params, cache, tokens) -> (next_tokens (B,1) int32,
    logits, new_cache)``: one greedy decode step in one process under
    ``torch.inference_mode`` (no autograd, no version counters: less host
    time an operator, and a decode step is host-bound). On a mesh of
    ranks a decode is `make_decoder`'s."""
    return _serve_step(cfg, None)


def _serve_step(cfg: ArchConfig, layout):
    """`make_serve_step` under `layout`: the tokens, cache and logits are
    this rank's rows (and vocab columns), the parameters its blocks, and
    the next tokens the global argmax."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        with spmd.use(layout):
            logits, new_cache = lm.decode_step(cfg, params, cache, tokens)
            last = logits[:, -1]
            next_tok = (spmd.vocab_argmax(last)
                        if last.shape[-1] != cfg.vocab_size
                        else torch.argmax(last, dim=-1)).to(torch.int32)
        return next_tok[:, None], logits, new_cache

    return serve_step


def long_context(batch: int) -> bool:
    """Whether a decode of `batch` rows is long-context decode, its
    cache's KV slots split over 'data' (the reference's rule: batch 1)."""
    return batch == 1


@dataclasses.dataclass(frozen=True)
class Decoder:
    """A greedy decode of a batch against a cache, as `make_decoder`
    lays it out: `step` is the serve step, `shardings` the cache's (None
    in one process), `layout` this rank's (None in one process), `long`
    whether every rank steps the one row against its KV slots."""
    step: Callable
    shardings: Any
    layout: Any
    long: bool

    def place(self, cache):
        """A whole cache (on the host) cut to this rank's blocks."""
        if self.shardings is None:
            return cache
        return shd.place(cache, self.shardings)

    def rows(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the global `tokens`."""
        if self.layout is None or self.long:
            return tokens
        return spmd.local_rows(self.layout, {"tokens": tokens})["tokens"]

    def whole(self, ids: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `ids` (this rank's `rows`)."""
        if self.layout is None or self.long:
            return ids
        return spmd.all_gather(self.layout, self.layout.batch, ids, 0,
                               count=False)


def make_decoder(cfg: ArchConfig, batch: int, cache_len: int, *,
                 mesh=None) -> Decoder:
    """The decode of `batch` rows against a `cache_len`-slot cache, laid
    out once for the cache's placement and the step that reads it. On a
    `mesh` of ranks' devices (or an abstract one) a long-context decode
    (`long_context`) splits each KV cache's slots over 'data'
    (``cache_shardings(seq_shard=True)``) and every rank steps the one
    row against its block of them (`spmd.decode_layout`); a larger batch
    splits its rows over the batch axes. Without a mesh of ranks: one
    process, the cache whole."""
    layout = spmd.layout_of(mesh) if mesh is not None else None
    long = long_context(batch)
    if layout is None:
        return Decoder(_serve_step(cfg, None), None, None, long)
    sh = shd.cache_shardings(mesh, cfg, lm.cache_spec(cfg, batch, cache_len),
                             seq_shard=long)
    step = _serve_step(cfg, spmd.decode_layout(layout, cache_len) if long
                       else layout)
    return Decoder(step, sh, layout, long)


def make_prefill_step(cfg: ArchConfig, *, chunk: int = 2048, mesh=None):
    """``prefill_step(params, batch) -> logits``, without autograd (under
    a `mesh` of ranks' devices: this rank's rows of the global batch, its
    vocab columns)."""
    layout = spmd.layout_of(mesh) if mesh is not None else None

    @torch.no_grad()
    def prefill_step(params, batch):
        with spmd.use(layout):
            if layout is not None:
                batch = spmd.local_rows(layout, batch)
            logits, _ = lm.forward(cfg, params, batch, chunk=chunk)
        return logits

    return prefill_step


# ---------------------------------------------------------------------------
# Abstract inputs for the dry-run
# ---------------------------------------------------------------------------

def train_state_specs(cfg: ArchConfig, *, stacked: bool = False):
    """(state_sds, state_shardings_fn(mesh)) for the full train state; the
    optimizer state's shapes come from its ``init`` on meta tensors."""
    pspecs = lm.param_specs(cfg, stacked=stacked)
    params_sds = tree_sds(pspecs)
    opt = make_optimizer(cfg.optimizer)
    opt_sds = tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype),
                       opt.init(tree_abstract(pspecs)))
    state_sds = {"params": params_sds, "opt": opt_sds,
                 "step": TensorSpec((), torch.int32)}

    def shardings(mesh):
        return {
            "params": shd.param_shardings(mesh, pspecs),
            "opt": shd.opt_state_shardings(mesh, pspecs, opt_sds),
            "step": shd.NamedSharding(mesh, ()),
        }

    return state_sds, shardings


def abstract_inputs(cfg: ArchConfig, kind: str, b: int, seq: int, *,
                    stacked: bool = False) -> dict:
    """`TensorSpec` inputs of a `kind` ("train", "prefill" or "decode")
    step at batch `b` and sequence (decode: cache) length `seq`.

    train:   {"batch": {tokens|embeds [, positions], labels}}
    prefill: {"batch": {tokens|embeds [, positions]}}
    decode:  {"cache": ..., "tokens": (B,1)}
    """
    i32 = torch.int32

    def batch_specs(with_labels: bool):
        d: dict = {}
        if cfg.frontend == "none":
            d["tokens"] = TensorSpec((b, seq), i32)
        else:
            d["embeds"] = TensorSpec((b, seq, cfg.d_model),
                                     getattr(torch, cfg.dtype))
        if cfg.mrope_sections:
            d["positions"] = TensorSpec((3, b, seq), i32)
        if with_labels:
            d["labels"] = TensorSpec((b, seq), i32)
        return d

    if kind == "train":
        return {"batch": batch_specs(with_labels=True)}
    if kind == "prefill":
        return {"batch": batch_specs(with_labels=False)}
    # decode: one new token against a seq_len cache
    return {"cache": lm.cache_spec(cfg, b, seq, stacked=stacked),
            "tokens": TensorSpec((b, 1), i32)}


def input_specs(cfg: ArchConfig, shape_name: str, *, stacked: bool = False):
    """(inputs_sds, shardings_fn(mesh)) for one (arch x shape) cell; the
    inputs are `abstract_inputs` at the shape's batch and length."""
    s = SHAPES[shape_name]
    b, seq, kind = s["global_batch"], s["seq_len"], s["kind"]
    inputs = abstract_inputs(cfg, kind, b, seq, stacked=stacked)

    def shardings(mesh):
        if kind in ("train", "prefill"):
            bs: dict = {}
            for k, v in inputs["batch"].items():
                bdim = 1 if k == "positions" else 0
                bs[k] = shd.data_sharding(mesh, len(v.shape), batch_dim=bdim)
            return {"batch": bs}
        long = long_context(b)  # shard the KV sequence over 'data'
        return {
            "cache": shd.cache_shardings(mesh, cfg, inputs["cache"],
                                         seq_shard=long),
            "tokens": shd.NamedSharding(mesh, ()) if long
            else shd.data_sharding(mesh, 2),
        }

    return inputs, shardings
