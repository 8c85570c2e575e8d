"""Model assembly: embed -> [attention|mamba (+ MLP|MoE)] x L -> norm -> head.

The port of `repro.models.lm`. One composable definition covers all 10
architectures via ArchConfig.layer_pattern / is_moe_layer: dense decoders,
encoder-only (hubert), SSM (mamba2), MoE (mixtral/kimi), hybrid MoE
(jamba), and the stubbed-frontend modalities (hubert audio frames, qwen2-vl
patches + M-RoPE).

The model is plain functions over a parameter tree of dicts and lists of
tensors in the reference's layout. Layers run eagerly, each block under
activation checkpointing (`torch.utils.checkpoint`, non-reentrant) when
``cfg.remat`` and autograd is recording: the reference's ``jax.checkpoint``.
The stacked layout (``stacked=True``) loops over its stacks where the
reference scans.

Under a sharded step (`training.spmd`) the tree holds this rank's blocks:
each block's parameters are gathered whole along 'data' inside its
checkpointed function (`spmd.gather_params`, so the backward re-gathers),
the embedding, the head and the loss run on the rank's vocab rows where
'model' splits the vocab (`spmd.vocab_lookup`, `spmd.vocab_cross_entropy`)
and the layers on its heads (`models.layers`).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.common import BATCH as BATCH_AXES
from repro_torch.models.common import constrain as _constrain
from repro_torch.models.params import ParamSpec, TensorSpec
from repro_torch.optim.optimizers import tree_map
from repro_torch.training import spmd

F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def _block_specs(cfg: ArchConfig, i: int) -> dict:
    dt, d = cfg.dtype, cfg.d_model
    kind = cfg.layer_kind(i)
    blk: dict = {"norm1": L.rmsnorm_spec(d)}
    if kind == "mamba":
        blk["mixer"] = M.mamba_specs(cfg, dt)
    else:
        blk["mixer"] = L.attention_specs(cfg, dt)
    if cfg.d_ff:
        blk["norm2"] = L.rmsnorm_spec(d)
        if cfg.is_moe_layer(i):
            blk["ffn"] = MOE.moe_specs(cfg, dt)
        else:
            blk["ffn"] = L.mlp_specs(cfg, dt)
    return blk


def _top_spec(cfg: ArchConfig, name: str) -> ParamSpec:
    """The spec of a leaf outside the blocks: embed, head, final_norm."""
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": ParamSpec((v, d), ("vocab", "embed"), cfg.dtype),
            "head": ParamSpec((d, v), ("embed", "vocab"), cfg.dtype),
            "final_norm": L.rmsnorm_spec(d)}[name]


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, (None,) + spec.axes, spec.dtype,
                     spec.init_scale)


def param_specs(cfg: ArchConfig, *, stacked: bool = False) -> dict:
    """stacked=True groups layers into pattern-period stacks (leading dim:
    the repeats) that `forward` loops over; stacked=False unrolls every
    layer."""
    tree: dict = {"embed": _top_spec(cfg, "embed"),
                  "final_norm": _top_spec(cfg, "final_norm")}
    if not cfg.tie_embeddings:
        tree["head"] = _top_spec(cfg, "head")
    if not stacked:
        tree["blocks"] = [_block_specs(cfg, i) for i in range(cfg.n_layers)]
        return tree
    period = cfg.pattern_period
    n_rep = cfg.n_layers // period
    rem = cfg.n_layers - n_rep * period
    tree["blocks_stacked"] = [
        tree_map(lambda s: _stack_spec(s, n_rep), _block_specs(cfg, j))
        for j in range(period)]
    tree["blocks_tail"] = [_block_specs(cfg, n_rep * period + j)
                           for j in range(rem)]
    return tree


def _index(tree, r: int):
    """Repeat `r` of a stacked tree (every leaf's leading dim)."""
    return tree_map(lambda a: a[r], tree)


def _remat(cfg: ArchConfig, fn, *args):
    """`fn(*args)`, under activation checkpointing when ``cfg.remat`` and
    autograd is recording."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block_apply(cfg: ArchConfig, i: int, p: dict, x, positions, *,
                 cache=None, chunk: int = 2048):
    kind = cfg.layer_kind(i)
    if spmd.active() is not None:
        p = spmd.gather_params(p, _block_specs(cfg, i))
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    if kind == "mamba":
        mixed, new_cache = M.mamba_block(p["mixer"], cfg, h, cache=cache)
    else:
        mixed, new_cache = L.attention(
            p["mixer"], cfg, h, positions, kind, cache=cache, chunk=chunk,
            sections=cfg.mrope_sections)
    x = x + mixed
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.d_ff:
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        if cfg.is_moe_layer(i):
            y, aux = MOE.moe_ffn(p["ffn"], cfg, h2, cfg.act)
        else:
            y = L.mlp(p["ffn"], h2, cfg.act, d_ff=cfg.d_ff)
        x = x + y
    return x, new_cache, aux


def _top(cfg: ArchConfig, params: dict, name: str):
    """Leaf `name` outside the blocks, whole along 'data'."""
    return spmd.gather_data(params[name], _top_spec(cfg, name))


def _lookup(cfg: ArchConfig, params: dict, tokens):
    """The token embeddings: a vocab-parallel lookup where this rank holds
    a share of the vocab rows."""
    embed = _top(cfg, params, "embed")
    if embed.shape[0] != cfg.vocab_size:
        return spmd.vocab_lookup(embed, tokens)
    return embed[tokens.long()]


def _embed_and_positions(cfg, params, batch):
    if "embeds" in batch:
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
    else:
        x = _constrain(_lookup(cfg, params, batch["tokens"]),
                       BATCH_AXES, None, None)
    b, s = x.shape[:2]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        positions = pos.expand(b, s)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, b, s)
    return x, positions


def _head(cfg, params, x):
    """Logits over the vocab columns this rank holds (all of them in one
    process)."""
    x = L.rmsnorm(x, _top(cfg, params, "final_norm"), cfg.norm_eps)
    head = (_top(cfg, params, "embed").T if cfg.tie_embeddings
            else _top(cfg, params, "head"))
    if head.shape[1] != cfg.vocab_size:
        x = spmd.enter_model(x)
    return _constrain(x @ head, BATCH_AXES, None, "model")


def forward(cfg: ArchConfig, params: dict, batch: dict, *,
            chunk: int = 2048):
    """Train/prefill forward. batch: {"tokens"|"embeds", ["positions"]}.
    Returns (logits, aux_loss). Detects stacked vs unrolled param layout."""
    x, positions = _embed_and_positions(cfg, params, batch)
    aux_total = torch.zeros((), dtype=F32, device=x.device)

    if "blocks" in params:
        for i, blk in enumerate(params["blocks"]):
            def run(x, blk, i=i):
                y, _, aux = _block_apply(cfg, i, blk, x, positions,
                                         chunk=chunk)
                return y, aux
            x, aux = _remat(cfg, run, x, blk)
            x = _constrain(x, BATCH_AXES, None, None)
            aux_total = aux_total + aux
    else:
        period = cfg.pattern_period

        def period_fn(x, blk_stack):
            aux = torch.zeros((), dtype=F32, device=x.device)
            for j in range(period):
                x, _, a = _block_apply(cfg, j, blk_stack[j], x, positions,
                                       chunk=chunk)
                aux = aux + a
            return _constrain(x, BATCH_AXES, None, None), aux

        n_rep = cfg.n_layers // period
        for r in range(n_rep):
            x, a = _remat(cfg, period_fn, x,
                          _index(params["blocks_stacked"], r))
            aux_total = aux_total + a
        for j, blk in enumerate(params["blocks_tail"]):
            x, _, a = _block_apply(cfg, n_rep * period + j, blk, x,
                                   positions, chunk=chunk)
            aux_total = aux_total + a

    return _head(cfg, params, x), aux_total


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def _layer_cache_spec(cfg: ArchConfig, i: int, batch: int,
                      seq_len: int) -> dict:
    dt = getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim
    kind = cfg.layer_kind(i)
    length = TensorSpec((), torch.int32)
    if kind == "mamba":
        return {
            "conv": TensorSpec(
                (batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                dt),
            "ssm": TensorSpec(
                (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim), F32),
            "length": length,
        }
    cap = min(cfg.window, seq_len) if kind == "local" else seq_len
    kv = TensorSpec((batch, cap, cfg.n_kv_heads, hd), dt)
    return {"k": kv, "v": kv, "length": length}


def cache_spec(cfg: ArchConfig, batch: int, seq_len: int, *,
               stacked: bool = False) -> dict:
    """`TensorSpec` tree for the decode cache (no allocation)."""
    if not stacked:
        return {"layers": [_layer_cache_spec(cfg, i, batch, seq_len)
                           for i in range(cfg.n_layers)]}
    period = cfg.pattern_period
    n_rep = cfg.n_layers // period

    def stack(s):
        return TensorSpec((n_rep,) + s.shape, s.dtype)

    return {
        "stacked": [tree_map(stack,
                               _layer_cache_spec(cfg, j, batch, seq_len))
                    for j in range(period)],
        "tail": [_layer_cache_spec(cfg, n_rep * period + j, batch, seq_len)
                 for j in range(cfg.n_layers - n_rep * period)],
    }


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
               length: int = 0, stacked: bool = False,
               device=None) -> dict:
    """Zeros of `cache_spec` on `device` (`resolve_device`: the card unless
    ``"cpu"`` is named); the lengths (int32 leaves of at most one dim) hold
    `length`."""
    device = resolve_device(device)
    return tree_map(
        lambda s: torch.full(s.shape, length, dtype=s.dtype, device=device)
        if s.dtype == torch.int32 and len(s.shape) <= 1
        else torch.zeros(s.shape, dtype=s.dtype, device=device),
        cache_spec(cfg, batch, seq_len, stacked=stacked))


def decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens, *,
                positions=None):
    """One-token decode. tokens (B,1) int32. Returns (logits, new_cache).
    Handles both unrolled ("layers") and stacked cache/param layouts."""
    x = _lookup(cfg, params, tokens)
    b = x.shape[0]
    if "layers" in cache:
        ln = cache["layers"][0]["length"]
    elif cache["stacked"]:
        ln = cache["stacked"][0]["length"][0]
    else:
        ln = cache["tail"][0]["length"]
    if positions is None:
        positions = ln.reshape(1, 1).expand(b, 1).to(torch.int32)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, b, 1)

    if "layers" in cache:
        new_layers = []
        for i, blk in enumerate(params["blocks"]):
            x, new_c, _ = _block_apply(cfg, i, blk, x, positions,
                                       cache=cache["layers"][i])
            new_layers.append(new_c)
        return _head(cfg, params, x), {"layers": new_layers}

    period = cfg.pattern_period
    n_rep = cfg.n_layers // period
    new_stacked = [[] for _ in range(period)]
    for r in range(n_rep):
        for j in range(period):
            x, new_c, _ = _block_apply(
                cfg, j, _index(params["blocks_stacked"][j], r), x, positions,
                cache=_index(cache["stacked"][j], r))
            new_stacked[j].append(new_c)
    new_stacked = [tree_map(lambda *xs: torch.stack(xs), *reps)
                   for reps in new_stacked]
    new_tail = []
    for j, blk in enumerate(params["blocks_tail"]):
        x, new_c, _ = _block_apply(cfg, n_rep * period + j, blk, x,
                                   positions, cache=cache["tail"][j])
        new_tail.append(new_c)
    return _head(cfg, params, x), {"stacked": new_stacked, "tail": new_tail}


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def loss_fn(cfg: ArchConfig, params: dict, batch: dict, *,
            aux_weight: float = 0.01, chunk: int = 2048):
    logits, aux = forward(cfg, params, batch, chunk=chunk)
    if logits.shape[-1] != cfg.vocab_size:      # this rank's vocab columns
        ce = spmd.vocab_cross_entropy(logits, batch["labels"])
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    # CE via select+reduce (the reference's: no gather along the vocab axis,
    # which a model-sharded vocab would have to replicate)
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    vocab_iota = torch.arange(lf.shape[-1], dtype=torch.int32,
                              device=lf.device)
    gold = torch.sum(torch.where(vocab_iota == batch["labels"][..., None],
                                 lf, 0.0), dim=-1)
    ce = torch.mean(lse - gold)
    metrics = {"ce": ce, "aux": aux}
    return ce + aux_weight * aux, metrics
