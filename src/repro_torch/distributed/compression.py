"""int8 quantization with error feedback: gradients and halo slabs.

The port of `repro.distributed.compression`, in plain torch. Scheme:

    g_fb   = g + err                        # error feedback (memory = g shape)
    scale  = max(|g_fb|) / 127              # shared across the axis (pmean)
                                            # or the slab's own (halo slabs)
    q      = round(g_fb / scale)  in int8 range
    g_out  = sum(q) * scale / N             # mean gradient
    err'   = g_fb - q * scale               # residual, fed back next step

`torch.round` rounds half to even, as `jnp.round` does, so `quantize_slab`
gives the reference's bits on the same float32 input. One process holds
every member of a mesh axis in this port, so `compressed_pmean` takes the
members' tensors as a sequence instead of reducing over a named axis.
"""

from __future__ import annotations

import torch


def _flatten(tree):
    """Leaves of a dict/list/tuple tree of tensors, and a function that
    rebuilds the tree from a list of new leaves in the same order."""
    if isinstance(tree, dict):
        parts = [_flatten(tree[k]) for k in tree]
        keys = list(tree)
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        keys = None
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, at = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[at:at + n]))
            at += n
        return dict(zip(keys, out)) if keys is not None else type(tree)(out)

    return [x for p in parts for x in p[0]], rebuild


def compressed_pmean(gs, errs):
    """int8 error-feedback mean over the members of one mesh axis.

    `gs` and `errs` hold one tree (a tensor, or a dict/list/tuple of them)
    per member, in axis order. The scale is the largest ``|g + err|`` over
    every member; the sum runs in member order on the first member's
    device. Returns ``(means, new_errs)``, one tree per member.
    """
    n = len(gs)

    def one(*leaves):
        g, e = leaves[:n], leaves[n:]
        fb = [a + b.to(a.device) for a, b in zip(g, e)]
        dev = fb[0].device
        amax = torch.stack([f.abs().max().to(dev) for f in fb]).max()
        scale = torch.clamp(amax / 127.0, min=1e-30)
        qs = [torch.clamp(torch.round(f / scale.to(f.device)), -127, 127)
              for f in fb]
        total = qs[0]
        for q in qs[1:]:
            total = total + q.to(dev)
        mean = total * scale / n
        return tuple([mean.to(a.device, a.dtype) for a in g]
                     + [(f - q * scale.to(f.device)).to(b.dtype)
                        for f, q, b in zip(fb, qs, e)])

    flat = [_flatten(t) for t in gs]
    eflat = [_flatten(t)[0] for t in errs]
    per_leaf = [one(*[f[0][i] for f in flat], *[e[i] for e in eflat])
                for i in range(len(flat[0][0]))]
    means = [flat[k][1]([p[k] for p in per_leaf]) for k in range(n)]
    new_errs = [flat[k][1]([p[n + k] for p in per_leaf]) for k in range(n)]
    return means, new_errs


def quantize_slab(x, err=None):
    """Sender-side int8 quantization of one halo slab (+ error feedback).

    The scale is the slab's own (max over this slab only): the receiver
    gets it shipped beside the int8 payload. Returns ``(q_int8,
    scale_f32_scalar, new_err_f32)``; `err` is the float32 residual of the
    previous quantization of the same slab, or None for no feedback.
    """
    x_fb = x.float() if err is None else x.float() + err
    scale = torch.clamp(x_fb.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x_fb / scale), -127, 127).to(torch.int8)
    new_err = x_fb - q.float() * scale
    return q, scale, new_err


def dequantize_slab(q, scale, dtype):
    """Reconstruct a halo slab from its int8 payload and shipped scale."""
    return (q.float() * scale).to(dtype)


def init_error_state(params):
    """Zero error-feedback residuals matching a tree of tensors."""
    leaves, rebuild = _flatten(params)
    return rebuild([torch.zeros_like(x) for x in leaves])


def compression_ratio(dtype=torch.float32) -> float:
    """Wire-bytes ratio against an uncompressed exchange of `dtype`."""
    return torch.empty((), dtype=dtype).element_size() / 1.0
