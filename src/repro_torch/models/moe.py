"""Capacity-routed MoE (GShard/Switch style), scatter/gather formulation.

The port of `repro.models.moe`. Tokens are routed without the (T, E, C)
one-hot dispatch tensor: per-token (expert, slot) indices come from
cumulative counts, tokens are scatter-added into the (E, C, D) expert
buffer (`index_add`), the expert FFNs run batched, and outputs gather back
weighted by the renormalized router probabilities. Each kept slot receives
exactly one token and every dropped assignment adds zeros, so the scatter
is exact in any order, on the card as well. The E axis carries the
"experts" logical axis.

Aux loss: the standard load-balance loss E * sum_e f_e * p_e.

Under a sharded step (`training.spmd`) the semantics stay the global
microbatch's: the capacity comes from its token count, and an
assignment's position within its expert is its rank in the global (token,
k) order, this rank's local position plus the counts of the batch shards
before it (`spmd.batch_counts`; rows lie in coordinate order over the
batch axes). Where 'model' splits the experts (or, where it does not
divide them, the experts' hidden columns), a rank runs the FFN on its
experts' slots only and each token's combine is a partial sum ending in
`spmd.reduce_model`; the tokens are already on every model rank, so no
all-to-all is needed. The buffer then holds min(capacity, local tokens)
slots an expert, in local order (every kept assignment's local position
lies below both). Every model rank routes whole, so the aux loss's
gradient is counted once (`spmd.once_over_model`) before the router's and
the input's gradients sum over 'model'. The aux loss of a batch shard is
``E * sum_e f_e * p_e`` with the global fractions f_e and the shard's
mean router probabilities, whose mean over the shards is the global
loss.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import nonlinearity
from repro_torch.models.params import ParamSpec
from repro_torch.training import spmd

F32 = torch.float32


def moe_specs(cfg: ArchConfig, dtype: str) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", None), "float32"),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp"), dtype),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"), dtype),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed"), dtype),
    }


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def expert_counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert (int64, (E,)): ``torch.bincount(flat_e,
    minlength=e)`` as a scatter-add of ones, which runs on meta tensors
    as well (the dry-run counts MoE FLOPs through it)."""
    return torch.zeros(e, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def moe_ffn(p, cfg: ArchConfig, x, act: str):
    """x: (B,S,D) -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    dev = x.device
    e_loc, f_loc = p["wi_gate"].shape[0], p["wi_gate"].shape[2]
    tp = e_loc != e or f_loc != cfg.d_ff     # split over 'model'
    shards = spmd.row_shards()
    router = p["router"]
    if tp:
        x, router = spmd.enter_model(x), spmd.enter_model(router)
    xf = x.reshape(t, d)
    cap = capacity(cfg, t * shards)

    logits = xf.float() @ router                       # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (T,K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # slot assignment: position of token-assignment within its expert, in
    # (token, k) order — exclusive cumulative count over the flat (T*K) list
    flat_e = gate_idx.reshape(-1)                      # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = expert_counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    if shards == 1:
        keep, total, slots = pos < cap, counts, cap
    else:
        before, total = spmd.batch_counts(counts)
        keep, slots = pos + before[flat_e] < cap, min(cap, t)
    mine = keep
    if e_loc != e:                                     # this rank's experts
        e0 = spmd.model_coord() * e_loc
        local_e = flat_e - e0
        mine = keep & (local_e >= 0) & (local_e < e_loc)
        slot = torch.where(mine, local_e * slots
                           + torch.clamp(pos, max=slots - 1), 0)
    else:
        slot = flat_e * slots + torch.clamp(pos, max=slots - 1)  # (T*K,)

    # dispatch: scatter-add token activations into the expert buffer
    xk = torch.repeat_interleave(xf, k, dim=0)         # (T*K, D) token per k
    buf = torch.zeros((e_loc * slots, d), dtype=x.dtype, device=dev
                      ).index_add(0, slot, torch.where(mine[:, None], xk, 0))
    buf = buf.reshape(e_loc, slots, d)

    # expert FFNs, batched over E
    h = nonlinearity(act)(torch.bmm(buf, p["wi_gate"]))
    h = h * torch.bmm(buf, p["wi_up"])
    out = torch.bmm(h, p["wo"]).reshape(e_loc * slots, d)

    # combine: gather each assignment's output, weight, sum over k
    yk = out[slot] * (gate_vals.reshape(-1, 1) * mine[:, None]).to(x.dtype)
    y = torch.sum(yk.reshape(t, k, d), dim=1).reshape(b, s, d)
    if tp:
        y = spmd.reduce_model(y)

    # load-balance aux loss: fraction of assignments vs mean router prob
    me = total.float() / (t * shards * k)
    pe = torch.mean(probs, dim=0)
    aux = e * torch.sum(me * pe)
    return y, (spmd.once_over_model(aux) if tp else aux)
