"""Transformer building blocks: RMSNorm, RoPE/M-RoPE, GQA attention
(full/sliding-window/encoder, qk-norm), gated & plain MLPs.

The port of `repro.models.layers`, on tensors. Attention is q-chunked with
a static python loop, bounding the logits memory to one chunk's; sliding-
window layers statically restrict each q-chunk's KV range, the
SWA-as-sequence-stencil correspondence of DESIGN.md. Logits and softmax
are float32 (the reference's ``preferred_element_type``: bfloat16 inputs
are widened, so every product is exact and sums run in float32), masked
positions take ``-1e30`` as the reference's do, and the weights go back to
the activation dtype before the value product. The caller wraps each block
in activation checkpointing (remat).

Under a sharded step (`training.spmd`) the weights are this rank's blocks,
whole along 'data': where 'model' splits the heads (or the MLP's hidden
width) the block runs on the rank's heads, column-parallel in and
row-parallel out, its input through `spmd.enter_model` and its output
through `spmd.reduce_model`. kv heads that do not split while the query
heads do are computed whole and each rank reads the ones its query heads
group with (global head h with kv head h // (H / Hkv)). A split is read
from the blocks' shapes, so one process runs the code unchanged. A
batch-1 decode step under `spmd.decode_layout` whose KV cache splits its
slots over 'data' holds a contiguous block of them a rank: the rank that
owns slot ``length % cap`` (or ``length``) writes the new k and v, the
mask is built on global slot positions, and the softmax combines across
'data' as flash-decoding does (`spmd.seq_softmax`, `spmd.seq_sum`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common as C
from repro_torch.models.params import ParamSpec
from repro_torch.training import spmd

F32 = torch.float32
MASKED = -1e30


# ---------------------------------------------------------------------------
# Norms & MLPs
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), dtype="float32")


def rmsnorm(x, w, eps: float = 1e-6):
    """RMS-normalise the last dim in float32, scale by `w`, back to
    `x`'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def mlp_specs(cfg: ArchConfig, dtype: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu2":    # plain 2-matrix FFN (hubert)
        return {"wi": ParamSpec((d, f), ("embed", "mlp"), dtype),
                "wo": ParamSpec((f, d), ("mlp", "embed"), dtype)}
    return {"wi_gate": ParamSpec((d, f), ("embed", "mlp"), dtype),
            "wi_up": ParamSpec((d, f), ("embed", "mlp"), dtype),
            "wo": ParamSpec((f, d), ("mlp", "embed"), dtype)}


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def nonlinearity(act: str):
    """The gated FFN's nonlinearity: tanh-gelu for ``"gelu"``, else silu."""
    return gelu if act == "gelu" else F.silu


def mlp(p, x, act: str, *, d_ff: int | None = None):
    """The FFN on `p`'s hidden columns. Under a sharded step a block of
    fewer than `d_ff` columns (the config's width) is this rank's share:
    its input enters the 'model' group and its partial outputs are summed
    over it."""
    tp = d_ff is not None and p["wo"].shape[0] != d_ff
    if tp:
        x = spmd.enter_model(x)
    if act == "gelu2":
        h = C.constrain(gelu(x @ p["wi"]), C.BATCH, None, C.MODEL)
    else:
        h = nonlinearity(act)(x @ p["wi_gate"]) * (x @ p["wi_up"])
        h = C.constrain(h, C.BATCH, None, C.MODEL)
    y = h @ p["wo"]
    return spmd.reduce_model(y) if tp else y


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float,
                sections: tuple[int, ...] = ()):
    """positions: (B,S) or (3,B,S) for M-RoPE. Returns cos,sin (B,S,half)."""
    half = head_dim // 2
    dev = positions.device
    freqs = theta ** (-torch.arange(half, dtype=F32, device=dev) / half)
    if sections:
        assert sum(sections) == half, (sections, half)
        # frequency i takes its position stream from its (t,h,w) section
        sec_id = torch.tensor([i for i, n in enumerate(sections)
                               for _ in range(n)], device=dev)
        pos = positions.float()[sec_id]                  # (half,B,S)
        ang = torch.movedim(pos, 0, -1) * freqs          # (B,S,half)
    else:
        ang = positions.float()[..., None] * freqs       # (B,S,half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B,S,H,D); cos/sin: (B,S,half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attention_specs(cfg: ArchConfig, dtype: str) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None), dtype),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", None), dtype),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", None), dtype),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed"), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((hd,), (None,), "float32")
        p["k_norm"] = ParamSpec((hd,), (None,), "float32")
    return p


def _gqa_weights(qr, k, scale, valid):
    """Softmax weights ``(B,G,R,Q,K)`` of grouped queries `qr` ``(B,Q,G,R,D)``
    against keys `k` ``(B,K,G,D)``: float32 logits, `valid` ``(Q,K)`` or
    ``(K,)`` (None: every key), back to the queries' dtype."""
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qr.float(), k.float()) * scale
    if valid is not None:
        logits = torch.where(valid, logits, MASKED)
    return torch.softmax(logits, dim=-1).to(qr.dtype)


def attention_core(q, k, v, *, kind: str, window: int, causal: bool,
                   q_offset: int = 0, chunk: int = 2048):
    """q (B,Sq,H,D) x k,v (B,Sk,Hkv,D) -> (B,Sq,H,D).

    Static q-chunking; "local" layers slice each chunk's KV range statically
    to [qpos - window + 1, qpos]. q_offset = absolute position of q[0]
    (decode: cache length; prefill: 0).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = d ** -0.5
    qr = q.reshape(b, sq, hkv, rep, d)
    chunk = min(chunk, sq)
    outs = []
    for s0 in range(0, sq, chunk):
        s1 = min(s0 + chunk, sq)
        qc = qr[:, s0:s1]
        if kind == "local" and causal:
            k0 = max(0, q_offset + s0 - window + 1)
        else:
            k0 = 0
        k1 = min(sk, q_offset + s1) if causal else sk
        kc, vc = k[:, k0:k1], v[:, k0:k1]
        m = None
        if causal:
            qpos = q_offset + s0 + torch.arange(s1 - s0, device=q.device)
            kpos = k0 + torch.arange(k1 - k0, device=q.device)
            m = qpos[:, None] >= kpos[None, :]
            if kind == "local":
                m &= (qpos[:, None] - kpos[None, :]) < window
        w = _gqa_weights(qc, kc, scale, m)
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", w, vc))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, d)


def _project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def _kv_for_heads(k, v, cfg: ArchConfig, h0: int, h_loc: int):
    """The kv heads (dim 2) that query heads ``h0 .. h0 + h_loc - 1`` read,
    from whole kv heads `k`, `v`: a slice where the heads group evenly, else
    one kv head per query head."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if h_loc % rep == 0:
        return (k[:, :, h0 // rep:(h0 + h_loc) // rep],
                v[:, :, h0 // rep:(h0 + h_loc) // rep])
    if rep % h_loc == 0:
        return k[:, :, h0 // rep:h0 // rep + 1], v[:, :, h0 // rep:h0 // rep + 1]
    idx = torch.arange(h0, h0 + h_loc, device=k.device) // rep
    return k.index_select(2, idx), v.index_select(2, idx)


def attention(p, cfg: ArchConfig, x, positions, kind: str, *,
              cache=None, chunk: int = 2048, sections=()):
    """Full attention block. cache: None (train/prefill) or dict with
    {"k","v","length"} for single-token decode (returns updated cache).
    Under a sharded step whose 'model' axis splits the heads, the block
    runs on this rank's heads (and its cache on its kv heads, or on all
    of them where they do not split) and sums its output over 'model'."""
    b, s, _ = x.shape
    h_loc = p["wq"].shape[1]
    tp = h_loc != cfg.n_heads           # the heads split over 'model'
    wk, wv = p["wk"], p["wv"]
    kv_whole = p["wk"].shape[1] == cfg.n_kv_heads
    qn, kn = p.get("q_norm"), p.get("k_norm")
    if tp:
        # leaves used on this rank's heads only: gradients summed
        x = spmd.enter_model(x)
        if kv_whole:
            wk, wv = spmd.enter_model(wk), spmd.enter_model(wv)
        if cfg.qk_norm:
            qn, kn = spmd.enter_model(qn), spmd.enter_model(kn)
    q = C.constrain(_project(x, p["wq"]), C.BATCH, None, C.MODEL, None)
    k = C.constrain(_project(x, wk), C.BATCH, None, C.MODEL, None)
    v = C.constrain(_project(x, wv), C.BATCH, None, C.MODEL, None)
    if cfg.qk_norm:
        q = rmsnorm(q, qn, cfg.norm_eps)
        k = rmsnorm(k, kn, cfg.norm_eps)
    cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                           sections)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    h0 = spmd.model_coord() * h_loc

    if cache is None:
        if tp and kv_whole:
            k, v = _kv_for_heads(k, v, cfg, h0, h_loc)
        # seq_parallel_attn shards the query sequence over the model axis
        # in the reference (no q-chunk loop); one card runs it unchunked
        out = attention_core(q, k, v, kind=kind, window=cfg.window,
                             causal=cfg.causal,
                             chunk=q.shape[1] if cfg.seq_parallel_attn
                             else chunk)
        new_cache = None
    else:
        # decode: append (ring-buffered for local layers) and attend
        ck, cv, ln = cache["k"], cache["v"], cache["length"]
        cap = whole = ck.shape[1]
        seq_len = (spmd.active().seq_len if spmd.active() is not None
                   else 0)
        if seq_len:       # a batch-1 decode: the slots may split on 'data'
            whole = min(cfg.window, seq_len) if kind == "local" else seq_len
        off = spmd.seq_block(whole, cap)
        idx = (ln % whole if kind == "local" else ln).reshape(1).long()
        if cap == whole:
            ck = ck.index_copy(1, idx, k)
            cv = cv.index_copy(1, idx, v)
        else:             # only the owner of the slot writes it
            at = torch.clamp(idx - off, 0, cap - 1)
            mine = (idx >= off) & (idx < off + cap)
            ck = ck.index_copy(1, at, torch.where(
                mine, k, ck.index_select(1, at)))
            cv = cv.index_copy(1, at, torch.where(
                mine, v, cv.index_select(1, at)))
        kpos_abs = off + torch.arange(cap, device=ck.device)
        if kind == "local":
            # ring buffer slot i holds the largest position p <= ln with
            # p % cap == i; negative p = slot not yet filled
            kpos = ln - torch.remainder(ln - kpos_abs, whole)
            valid = (kpos >= 0) & (ln - kpos < cfg.window)
        else:
            valid = kpos_abs <= ln
        rk, rv = (_kv_for_heads(ck, cv, cfg, h0, h_loc) if tp and kv_whole
                  else (ck, cv))
        g = rk.shape[2]
        qr = q.reshape(b, 1, g, h_loc // g, -1)
        scale = cfg.resolved_head_dim ** -0.5
        if cap == whole:
            w = _gqa_weights(qr, rk, scale, valid)
            out = torch.einsum("bgrqk,bkgd->bqgrd", w, rv)
        else:
            logits = torch.einsum("bqgrd,bkgd->bgrqk", qr.float(),
                                  rk.float()) * scale
            w = spmd.seq_softmax(torch.where(valid, logits, MASKED))
            out = spmd.seq_sum(torch.einsum("bgrqk,bkgd->bqgrd",
                                            w.to(qr.dtype), rv))
        out = out.reshape(b, 1, h_loc, -1)
        new_cache = {"k": ck, "v": cv, "length": ln + 1}

    y = out.reshape(b, s, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    return (spmd.reduce_model(y) if tp else y), new_cache
