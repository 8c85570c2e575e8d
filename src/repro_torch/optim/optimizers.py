"""Optimizers on tensors, with the reference's arithmetic: AdamW and
Adafactor (a factored second moment, for the 398B/1T architectures).

The port of `repro.optim.optimizers`. An `Optimizer` is a pair of
functions ``(init, update)`` over a tensor or a dict, list or tuple of
tensors, with state a tree as well, so a train state round-trips through
numpy and `distributed.checkpoint` unchanged. Updates run without autograd
and compute what the reference computes. AdamW: moments in float32, bias
correction by ``b ** (step + 1)``, ``weight_decay * p`` added to the
update, and ``-lr_t * u`` cast back to the parameter dtype (which
`torch.optim.AdamW` does not). Adafactor: momentum-free, row and column
second moments for every leaf of two or more dims (``{"vr", "vc"}``), a
full one for vectors (``{"v"}``), RMS update clipping and a step relative
to the parameter's RMS; under a sharded step its means run on the blocks
(``update(..., means=)``).

Step counts and learning rates are 0-d float32 tensors on the host; a 0-d
host tensor multiplies a CUDA tensor without a sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable   # (grads, state, params, step) -> (updates, new_state)


def tree_map(fn, *trees):
    """`fn` over the tensors of same-structured trees (a tensor, or a dict,
    list or tuple of trees)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree, is_leaf=None) -> list:
    """The tensors of a tree, in `tree_map`'s order; a node for which
    ``is_leaf`` holds (Adafactor's per-leaf state dicts) is a leaf too."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(keystr, leaf)`` pairs in the reference's flattening order: names
    as ``jax.tree_util.keystr`` writes them (``"['blocks'][0]['wq']"``),
    dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in tree_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in `tree_leaves`'
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1):
    """Linear warmup to `peak_lr`, then a cosine down to ``floor *
    peak_lr`` at `total`: ``lr(step) -> 0-d float32 tensor``."""
    def lr(step):
        step = _f32(step)
        # warmup=0 means no warmup, not a division by zero
        warm = peak_lr * (step + 1) / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


@torch.no_grad()
def global_norm(tree, sq_sum=None) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32. `sq_sum`,
    given the leaves' squared norms in `tree_leaves` order, returns their
    total instead of the plain sum (a sharded step's: each element once,
    over every rank, `training.spmd.norm_sq_sum`)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves) if sq_sum is None else sq_sum(leaves))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, sq_sum=None):
    """Scale `grads` so their global norm (`global_norm` with `sq_sum`) is
    at most `max_norm`: ``(clipped, norm before clipping)``."""
    norm = global_norm(grads, sq_sum)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    """AdamW with decoupled weight decay; `lr` a float or ``lr(step)``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        step_f = _f32(step) + 1.0
        lr_t = lr_fn(step)

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** step_f)
            vhat = v / (1 - b2 ** step_f)
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype), m, v

        out = [upd(*t) for t in zip(
            tree_leaves(grads), tree_leaves(state["m"]),
            tree_leaves(state["v"]), tree_leaves(params))]
        unf = lambda i: tree_unflatten(grads, [o[i] for o in out])
        return unf(0), {"m": unf(1), "v": unf(2)}

    return Optimizer(init, update)


def is_moments(x) -> bool:
    """Whether `x` is one leaf's Adafactor state (``{"vr", "vc"}`` or
    ``{"v"}``)."""
    return isinstance(x, dict) and ("v" in x or "vr" in x)


class _Means:
    """One process's means (the interface of `training.spmd.BlockMeans`
    on whole leaves)."""

    @staticmethod
    def mean(x, dims, pdims, keepdim: bool = False):
        if dims is None:
            return torch.mean(x)
        return torch.mean(x, dim=dims, keepdim=keepdim)

    @staticmethod
    def vc_in(vc):
        return vc

    vc_out = vc_in


def adafactor(lr=1e-2, decay=0.8, eps1=1e-30, eps2=1e-3,
              clip_threshold=1.0) -> Optimizer:
    """Shazeer & Stern 2018, momentum-free: O(n+m) state for (n,m) matrices."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def one(p):
            zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                              device=p.device)
            if _factored(p.shape):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        return tree_map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step, means=None):
        """`means`, under a sharded step: per leaf (`tree_leaves` order)
        a `training.spmd.BlockMeans`, whose means over this rank's blocks
        equal the global leaf's."""
        step_f = _f32(step) + 1.0
        beta = 1.0 - step_f ** (-decay)
        lr_t = lr_fn(step)

        def upd(g, s, p, m):
            g = g.float()
            g2 = g * g + eps1
            n = g.ndim
            mean = _Means() if m is None else m
            if _factored(g.shape):
                vr = beta * s["vr"] + (1 - beta) * mean.mean(
                    g2, -1, (n - 1,))
                vc = beta * mean.vc_in(s["vc"]) + (1 - beta) * mean.mean(
                    g2, -2, (n - 2,))
                rfac = (vr / mean.mean(vr, -1, (n - 2,),
                                       keepdim=True))[..., None]
                u = g * torch.rsqrt(rfac * vc[..., None, :] + eps1)
                new_s = {"vr": vr, "vc": mean.vc_out(vc)}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps1)
                new_s = {"v": v}
            # update clipping (RMS)
            every = tuple(range(n))
            rms_u = torch.sqrt(mean.mean(u * u, None, every) + eps1)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            scale = torch.clamp(torch.sqrt(mean.mean(
                p.float() ** 2, None, every)), min=eps2)  # relative step
            return (-lr_t * scale * u).to(p.dtype), new_s

        leaves = tree_leaves(grads)
        out = [upd(*t) for t in zip(leaves, tree_leaves(state, is_moments),
                                    tree_leaves(params),
                                    means or [None] * len(leaves))]
        return (tree_unflatten(grads, [o[0] for o in out]),
                tree_unflatten(grads, [o[1] for o in out]))

    return Optimizer(init, update)


def make_optimizer(kind: str, lr=None) -> Optimizer:
    """The config's optimizer at the reference's default rates (AdamW
    3e-4, Adafactor 1e-2) unless `lr` is given."""
    if kind == "adamw":
        return adamw(lr=lr or 3e-4)
    if kind == "adafactor":
        return adafactor(lr=lr or 1e-2)
    raise ValueError(f"unknown optimizer {kind!r}")


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
