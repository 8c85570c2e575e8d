"""Mamba2 SSD (state-space duality) block with chunked scan.

The port of `repro.models.mamba`. Structural tie to the paper (DESIGN.md
Sec. 5): the chunked SSD algorithm is wavefront temporal blocking of a
linear recurrence. The chunk is the in-fast-memory time block (intra-chunk
work in quadratic "attention" form is the diamond interior), and the
carried state is the wavefront sliding across chunks. The inter-chunk
state recurrence is the only sequential part, O(L/Q * H*N*P) flops, and
runs as a python loop over chunks (the reference's ``lax.scan``); the heavy
intra-chunk products are batched over every chunk at once.

Single-token decode is the pure recurrence on (conv_state, ssm_state).

Under a sharded step (`training.spmd`) whose 'model' axis splits
``ssm_inner``, `wz` and `wx` are column-parallel and `out_proj` is
row-parallel, ending in `spmd.reduce_model`. Where the column blocks hold
whole heads the SSD scan, the D skip and the ssm state run on the rank's
heads, and the gated RMSNorm's sum of squares is summed over 'model';
elsewhere (heads that 'model' does not divide) `z` and `x` are gathered
whole, every rank runs every head, and each keeps its own columns before
the norm's weight. `wbc`, `wdt`, `a_log`, `d_skip` and `dt_bias` are
replicated over 'model' and enter it (their gradients summed). The conv
leaves split their concatenated [x | B | C] dim evenly, which does not
follow the heads, so they are gathered whole over 'model'
(`spmd.gather_model`, whose backward reduce-scatters onto the block) and
a rank takes its own x columns and all of B/C; the decode cache's conv
state is gathered for the step and the rank's block of the new state is
stored back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.training import spmd

F32 = torch.float32


def mamba_specs(cfg: ArchConfig, dtype: str) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        # separate projections (vs the reference's fused in_proj): each dim
        # is cleanly shardable on 'model'
        "wz": ParamSpec((d, di), ("embed", "ssm_inner"), dtype),
        "wx": ParamSpec((d, di), ("embed", "ssm_inner"), dtype),
        "wbc": ParamSpec((d, 2 * n), ("embed", None), dtype),
        "wdt": ParamSpec((d, h), ("embed", None), dtype),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "ssm_inner"),
                            dtype),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), "float32",
                            init_scale=0.0),
        "a_log": ParamSpec((h,), (None,), "float32"),
        "d_skip": ParamSpec((h,), (None,), "float32"),
        "dt_bias": ParamSpec((h,), (None,), "float32", init_scale=0.0),
        "norm": ParamSpec((di,), ("ssm_inner",), "float32"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"), dtype),
    }


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv. xbc (B,L,C); w (K,C). state: (B,K-1,C) for
    decode. Returns (out, new_state)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros_like(xbc[:, :k - 1])
    full = torch.cat([state, xbc], dim=1)
    new_state = full[:, full.shape[1] - (k - 1):]
    n = full.shape[1] - (k - 1)
    out = full[:, 0:n] * w[0]
    for i in range(1, k):
        out = out + full[:, i:n + i] * w[i]
    return F.silu(out + b), new_state


def _segsum(dA):
    """dA (..., Q) -> (..., Q, Q) lower-triangular cumulative sums:
    out[i,j] = sum_{j < m <= i} dA[m] for i >= j else -inf."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]   # sum_{j<m<=i}
    ii = torch.arange(q, device=dA.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """SSD forward. xh (B,L,H,P); dt (B,L,H) (post-softplus); a (H,) < 0;
    bmat/cmat (B,L,N) shared across heads (n_groups=1). Returns (B,L,H,P)."""
    b, l, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, l)
    assert l % q == 0, (l, q)
    nc = l // q

    xc = xh.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    da = dtc * a                                   # (B,nc,Q,H) log-decay
    da_t = torch.movedim(da, -1, -2)               # (B,nc,H,Q)

    # intra-chunk (the "diamond interior", quadratic in Q)
    lmask = torch.exp(_segsum(da_t))               # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)   # (B,nc,Q,Q)
    w = scores[:, :, None] * lmask                 # (B,nc,H,Q,Q)
    xdt = (xc * dtc[..., None]).float()            # weight inputs by dt
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xdt)

    # chunk state contributions: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j
    cum = torch.cumsum(da_t, dim=-1)               # (B,nc,H,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B,nc,H,Q)
    sc = torch.einsum("bchj,bcjn,bcjhp->bchnp", decay_to_end, bc, xdt)
    chunk_decay = torch.exp(cum[..., -1])          # (B,nc,H)

    # inter-chunk wavefront: tiny sequential state carry, emitting the
    # state ENTERING each chunk
    s_prev = torch.zeros((b, h, n, p), dtype=F32, device=xh.device)
    s_in = []
    for c in range(nc):
        s_in.append(s_prev)
        s_prev = chunk_decay[:, c, :, None, None] * s_prev + sc[:, c]
    s_in = torch.stack(s_in, dim=1)                # (B,nc,H,N,P)

    # contribution of the entering state to every position in the chunk
    state_decay = torch.exp(cum)                   # (B,nc,H,Q)
    y_inter = torch.einsum("bcin,bchi,bchnp->bcihp", cc, state_decay, s_in)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y.to(xh.dtype)


def mamba_block(pp, cfg: ArchConfig, x, *, cache=None, chunk: int = 256):
    """x (B,L,D) -> (y, new_cache). cache = {"conv","ssm","length"} for
    decode (L == 1)."""
    b, l, d = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    p = cfg.ssm_head_dim
    conv_dim = di + 2 * n
    di_loc = pp["wz"].shape[1]
    tp = di_loc != di                   # 'model' splits ssm_inner
    whole_heads = di_loc % p == 0       # the column blocks hold whole heads
    c0 = spmd.model_coord() * di_loc if tp else 0
    wbc, wdt = pp["wbc"], pp["wdt"]
    a_log, d_skip, dt_bias = pp["a_log"], pp["d_skip"], pp["dt_bias"]
    if tp:
        # leaves replicated over 'model', used on this rank's heads
        x, wbc, wdt, a_log, d_skip, dt_bias = map(
            spmd.enter_model, (x, wbc, wdt, a_log, d_skip, dt_bias))
    conv_w, conv_b = pp["conv_w"], pp["conv_b"]
    if conv_w.shape[1] != conv_dim:
        conv_w = spmd.gather_model(conv_w, 1)
        conv_b = spmd.gather_model(conv_b, 0)
    z = x @ pp["wz"]
    xs = x @ pp["wx"]
    bcmat = x @ wbc
    dt = x @ wdt
    own = tp and whole_heads            # x columns c0 .. c0 + di_loc only
    if tp and not whole_heads:
        z, xs = spmd.gather_model(z, -1), spmd.gather_model(xs, -1)
    if own:
        heads = slice(c0 // p, (c0 + di_loc) // p)
        a_log, d_skip, dt_bias = a_log[heads], d_skip[heads], dt_bias[heads]
        dt = dt[..., heads]
        cols = torch.cat([torch.arange(c0, c0 + di_loc, device=x.device),
                          torch.arange(di, conv_dim, device=x.device)])
        conv_w, conv_b = conv_w[:, cols], conv_b[cols]
    a = -torch.exp(a_log)                           # (H,) negative
    dt = F.softplus(dt.float() + dt_bias)           # (B,L,H)

    xs_in = xs
    xbc = torch.cat([xs, bcmat], dim=-1)
    conv_state = None
    if cache is not None:
        conv_state = cache["conv"]
        if conv_state.shape[-1] != conv_dim:
            conv_state = spmd.gather_model(conv_state, -1)
        whole_state = conv_state
        if own:
            conv_state = conv_state[..., cols]
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    dx = xs.shape[-1]
    xs, bmat, cmat = (xbc[..., :dx], xbc[..., dx:dx + n],
                      xbc[..., dx + n:])
    xh = xs.reshape(b, l, dx // p, p)

    if cache is None:
        y = ssd_chunked(xh, dt, a, bmat, cmat, chunk)
        new_cache = None
    else:
        # single-step recurrence: s' = exp(dt*a) s + dt * B (x) ; y = C s' + D x
        s = cache["ssm"]                            # (B,H,N,P) f32
        dt1 = dt[:, 0]                              # (B,H)
        dec = torch.exp(dt1 * a)                    # (B,H)
        outer = torch.einsum("bn,bhp->bhnp", bmat[:, 0].float(),
                             (xh[:, 0] * dt1[..., None]).float())
        s = dec[..., None, None] * s + outer
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].float(), s)
        y = y[:, None].to(x.dtype)                  # (B,1,H,P)
        if own:     # the new state holds every rank's x columns
            step_in = torch.cat([spmd.gather_model(xs_in, -1), bcmat],
                                dim=-1)
            new_conv = torch.cat([whole_state, step_in],
                                 dim=1)[:, -whole_state.shape[1]:]
        width = cache["conv"].shape[-1]
        if width != conv_dim:       # store this rank's block back
            new_conv = new_conv.narrow(-1, spmd.model_coord() * width,
                                       width)
        new_cache = {"conv": new_conv, "ssm": s,
                     "length": cache["length"] + 1}

    y = y + xh * d_skip[:, None].to(x.dtype)
    y = y.reshape(b, l, dx)
    # gated RMSNorm (mamba2's norm before out_proj)
    yf = y.float() * F.silu(z.float())
    if own:      # the mean over all of d_inner: the sum over 'model'
        var = spmd.sum_over_model(
            torch.sum(yf * yf, dim=-1, keepdim=True)) / di
    else:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + cfg.norm_eps)
    if tp and not whole_heads:
        yf = yf[..., c0:c0 + di_loc]
    yf = yf * pp["norm"]
    out = yf.to(x.dtype) @ pp["out_proj"]
    return (spmd.reduce_model(out) if tp else out), new_cache
