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
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import nonlinearity
from repro_torch.models.params import ParamSpec

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


def moe_ffn(p, cfg: ArchConfig, x, act: str):
    """x: (B,S,D) -> (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    dev = x.device
    xf = x.reshape(t, d)
    cap = capacity(cfg, t)

    logits = xf.float() @ p["router"]                  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (T,K)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # slot assignment: position of token-assignment within its expert, in
    # (token, k) order — exclusive cumulative count over the flat (T*K) list
    flat_e = gate_idx.reshape(-1)                      # (T*K,)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(t * k, device=dev) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    keep = pos < cap
    slot = flat_e * cap + torch.clamp(pos, max=cap - 1)  # (T*K,)

    # dispatch: scatter-add token activations into the expert buffer
    xk = torch.repeat_interleave(xf, k, dim=0)         # (T*K, D) token per k
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=dev).index_add(
        0, slot, torch.where(keep[:, None], xk, 0))
    buf = buf.reshape(e, cap, d)

    # expert FFNs, batched over E
    h = nonlinearity(act)(torch.bmm(buf, p["wi_gate"]))
    h = h * torch.bmm(buf, p["wi_up"])
    out = torch.bmm(h, p["wo"]).reshape(e * cap, d)

    # combine: gather each assignment's output, weight, sum over k
    yk = out[slot] * (gate_vals.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    y = torch.sum(yk.reshape(t, k, d), dim=1).reshape(b, s, d)

    # load-balance aux loss: fraction of assignments vs mean router prob
    me = counts.float() / (t * k)
    pe = torch.mean(probs, dim=0)
    aux = e * torch.sum(me * pe)
    return y, aux
