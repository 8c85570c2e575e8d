"""Differentiable MWD launches: a structural `torch.autograd.Function` adjoint.

The port of `repro.kernels.adjoint` (without `distributed_vjp`). The fused
MWD advance is linear in the solution levels, so its vector-Jacobian
product is itself a stencil advance: the adjoint operator derived by
`core.ir.adjoint` (tap offsets negated, variable coefficients transported
as rolled streams), run by the same K1 launch as the forward pass. The
backward pass is one adjoint K1 advance per time step plus O(surface)
frame bookkeeping, in plain PyTorch on the tensors' device.

One-step pullback (state ``(cur, prev) -> (new, cur)``; ``G``/``P`` the
cotangents of the two outputs, ``Ĝ`` the interior-masked ``G``, ``1_F``
the Dirichlet-frame indicator, ``Ã`` the adjoint tap application):

* 1st order::

      g_cur  = Ã(Ĝ) + G·1_F + P          g_prev = 0

* 2nd order (``new = 2·cur - prev + s·L(cur)`` in the interior)::

      g_cur  = 2·Ĝ + Ã(Ĝ) + G·1_F + P    g_prev = -Ĝ

  whose interior is one time_order=2 step of the adjoint op on the state
  ``(Ĝ, -P)``; the frame accumulation (`_frame_shell`, six boundary slabs)
  and the passthrough terms are added outside the kernel.

What the forward saves for the backward:

* 2nd order: the two output levels only. Earlier states are reconstructed
  by the forward kernel on the swapped state
  (``U_{t-2} = 2·U_{t-1} - U_t + s·L(U_{t-1})``), so the backward's memory
  does not grow with the step count.
* 1st order, constant coefficients: nothing.
* 1st order, variable coefficients: the per-step input states, stacked by
  1-step launches (bitwise equal to the fused N-step advance, since every
  method equals `ops.naive` bitwise); the coefficient gradient
  ``dL/dc_t[i] = Ĝ[i]·pre(i)·cur_in[i+off_t]`` needs them.

Scalar coefficients are compile-time constants of the launch and carry no
gradient; the solution levels and the stacked coefficient streams do.
Gradient launches resolve their plan registry-first under the ``vjp``
variant key, keyed on the adjoint operator (`resolve_adjoint_plan`).

On CUDA tensors every advance here is a K1 launch (``csrc/mwd.cu``) or
raises; on CPU tensors it is K1's plain version.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import ir, precision
from repro_torch.core.mwd import MWDPlan
from repro_torch.core.stencils import StencilSpec
from repro_torch.kernels import stencil_mwd

__all__ = ["mwd_diff", "mwd_diff_batched", "resolve_adjoint_plan"]


# ---------------------------------------------------------------------------
# trailing-axis helpers (a leading batch axis passes through everything)
# ---------------------------------------------------------------------------

def _core(a, r):
    return a[..., r:-r, r:-r, r:-r]


def _zero_frame(a, r):
    """Keep the interior of `a`, zero the Dirichlet frame."""
    out = torch.zeros_like(a)
    out[..., r:-r, r:-r, r:-r] = _core(a, r)
    return out


def _frame_only(a, r):
    """Keep the Dirichlet frame of `a`, zero the interior."""
    out = a.clone()
    out[..., r:-r, r:-r, r:-r] = 0
    return out


def _shift3(a, off, r):
    """Interior-shaped slice of `a` displaced by `off` (the sweep's shift)."""
    sl = tuple(slice(r + d, d - r if d - r else None) for d in off)
    return a[(...,) + sl]


def _slot(arrays, k):
    """Stream `k` of a stacked coefficient tensor (batch axes pass through)."""
    return arrays[..., k, :, :, :]


def _block(a, lo, hi):
    """``a[lo:hi]`` on the trailing 3 axes, zero-padded where the range
    leaves the domain (so taps read "outside" as zeros)."""
    sl, pads = [], []
    for ax, (l, h) in enumerate(zip(lo, hi)):
        n = a.shape[a.ndim - 3 + ax]
        sl.append(slice(max(l, 0), min(h, n)))
        pads.append((max(0, -l), max(0, h - n)))
    return F.pad(a[(...,) + tuple(sl)],
                 [p for pair in reversed(pads) for p in pair])


def _frame_regions(shape, r):
    """The six disjoint boundary slabs of a ``shape`` grid: z faces at full
    y×x extent, y faces z-restricted, x faces z,y-restricted."""
    nz, ny, nx = shape
    return (((0, r), (0, ny), (0, nx)),
            ((nz - r, nz), (0, ny), (0, nx)),
            ((r, nz - r), (0, r), (0, nx)),
            ((r, nz - r), (ny - r, ny), (0, nx)),
            ((r, nz - r), (r, ny - r), (0, r)),
            ((r, nz - r), (r, ny - r), (nx - r, nx)))


def _region(bounds):
    return (...,) + tuple(slice(lo, hi) for lo, hi in bounds)


def _add_frame(dst, r, *srcs):
    """``dst += _frame_only(src_0 + src_1 + ..., r)``, in place, slab by
    slab (the interior would add zeros, which changes no value)."""
    for bounds in _frame_regions(dst.shape[-3:], r):
        reg = _region(bounds)
        s = srcs[0][reg]
        for other in srcs[1:]:
            s = s + other[reg]
        dst[reg] += s


def _tap_sum(op: StencilSpec, cur, arrays, scalars):
    """Interior-shaped ``L(cur)``: the op's coefficient-weighted tap sum."""
    r = op.radius
    acc = None
    for coeff, taps in op.groups:
        s = None
        for t in taps:
            v = _shift3(cur, t.offset, r)
            s = v if s is None else s + v
        c = (scalars[coeff.index] if coeff.kind == "const"
             else _core(_slot(arrays, coeff.index), r))
        term = c * s
        acc = term if acc is None else acc + term
    return acc


# ---------------------------------------------------------------------------
# frame accumulation: the adjoint writes into the Dirichlet frame
# ---------------------------------------------------------------------------
#
# K1 holds the frame fixed (Dirichlet), but the true adjoint of the
# interior update accumulates into frame cells too: a frame cell j receives
# sum_t c'_t[j] * Ĝ[j + off'_t] whenever an interior output cell reads it.
# Only the tap-sum part lands there (the 2nd-order terms 2·cur - prev are
# interior-only), so the correction is the plain adjoint tap application
# restricted to the frame.

def _tap_apply_full(adj: ir.Adjoint, adj_arrays, adj_scalars, g):
    """Full-volume adjoint tap application (the reference for `_frame_shell`).

    ``out[j] = s' * sum_t c'_t[j] * g[j + off'_t]`` with ``g`` read as zero
    outside the domain; ``s'`` is the carried 2nd-order const scale (array
    scales were folded into the streams by `ir.adjoint`). O(volume).
    """
    op = adj.op
    r = op.radius
    shape = g.shape[-3:]
    gp = F.pad(g, [r] * 6)

    def shift(off):
        sl = tuple(slice(r + d, r + d + n) for d, n in zip(off, shape))
        return gp[(...,) + sl]

    acc = None
    for coeff, taps in op.groups:
        s = None
        for t in taps:
            v = shift(t.offset)
            s = v if s is None else s + v
        c = (adj_scalars[coeff.index] if coeff.kind == "const"
             else _slot(adj_arrays, coeff.index))
        term = c * s
        acc = term if acc is None else acc + term
    if op.scale is not None:            # 2nd-order const scale (never array)
        acc = acc * adj_scalars[op.scale.index]
    return acc


def _frame_shell(adj: ir.Adjoint, adj_arrays, adj_scalars, g, out=None):
    """Adjoint tap application restricted to the frame: O(surface·R) work.

    Computes `_tap_apply_full` on the six boundary slabs, each from a
    zero-padded context block of thickness ~3R. Returns a volume that is
    zero but on the frame; with `out`, adds the slabs into `out` in place
    instead (``out + _frame_shell(...)`` to the bit) and returns it.
    """
    op = adj.op
    r = op.radius
    add = out is not None
    if not add:
        out = torch.zeros_like(g)
    for bounds in _frame_regions(g.shape[-3:], r):
        (z0, z1), (y0, y1), (x0, x1) = bounds
        shape = (z1 - z0, y1 - y0, x1 - x0)
        ctx = _block(g, (z0 - r, y0 - r, x0 - r), (z1 + r, y1 + r, x1 + r))

        def shift(off):
            sl = tuple(slice(r + d, r + d + n) for d, n in zip(off, shape))
            return ctx[(...,) + sl]

        reg = _region(bounds)
        acc = None
        for coeff, taps in op.groups:
            s = None
            for t in taps:
                v = shift(t.offset)
                s = v if s is None else s + v
            c = (adj_scalars[coeff.index] if coeff.kind == "const"
                 else _slot(adj_arrays, coeff.index)[reg])
            term = c * s
            acc = term if acc is None else acc + term
        if op.scale is not None:
            acc = acc * adj_scalars[op.scale.index]
        if add:
            out[reg] += acc
        else:
            out[reg] = acc
    return out


# ---------------------------------------------------------------------------
# coefficient-stream gradients
# ---------------------------------------------------------------------------

def _coeff_grads(op: StencilSpec, cur_in, ghat, arrays, scalars, out=None):
    """One step's gradient wrt the stacked coefficient streams (zero frame).

    ``dL/dc_k[i] = Ĝ[i] · pre(i) · sum_{taps with array(k)} cur_in[i+off]``
    with ``pre`` the 2nd-order scale (1 for 1st order); an array-valued
    scale slot also receives ``Ĝ · L(cur_in)``. Coefficients are read at
    interior output cells only, so the frame stays zero. Returns a fresh
    gradient, or with `out` adds this step's into `out`'s interior in place
    (the reference's ``out + _coeff_grads(...)`` to the bit) and returns it.
    """
    if arrays is None:
        return None
    r = op.radius
    if out is None:
        out = torch.zeros_like(arrays)
    g = _core(ghat, r)
    pre = g
    if op.time_order == 2 and op.scale is not None:
        s = (scalars[op.scale.index] if op.scale.kind == "const"
             else _core(_slot(arrays, op.scale.index), r))
        pre = g * s
    scale_k = (op.scale.index if op.time_order == 2 and op.scale is not None
               and op.scale.kind == "array" else None)
    held = None                 # the scale slot's tap term, merged first
    for coeff, taps in op.groups:
        if coeff.kind != "array":
            continue
        ssum = None
        for t in taps:
            v = _shift3(cur_in, t.offset, r)
            ssum = v if ssum is None else ssum + v
        if coeff.index == scale_k:
            held = pre * ssum
        else:
            _core(_slot(out, coeff.index), r).add_(pre * ssum)
    if scale_k is not None:
        term = g * _tap_sum(op, cur_in, arrays, scalars)
        _core(_slot(out, scale_k), r).add_(
            term if held is None else held + term)
    return out


# ---------------------------------------------------------------------------
# the autograd core (cached per static configuration)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _diff_core(op: StencilSpec, scalars, n_steps: int, fwd_plan, adj_plan,
               acc_dtype, batched: bool):
    """The `torch.autograd.Function` of one static configuration.

    `fwd_plan` / `adj_plan` are ``(d_w, n_f, fused)`` triples for the
    forward and gradient launches; `scalars` the float tuple the kernels
    inline. ``Function.apply(cur, prev, arrays) -> (cur', prev')``.
    """
    adj = ir.adjoint(op)
    run = stencil_mwd.mwd_run_batched if batched else stencil_mwd.mwd_run
    r = op.radius
    fdw, fnf, ffu = fwd_plan
    adw, anf, afu = adj_plan
    has_arrays = op.n_coeff_arrays > 0

    def fwd_run(state, arrays, steps):
        return run(op, state, arrays, scalars, steps,
                   d_w=fdw, n_f=fnf, fused=ffu, acc_dtype=acc_dtype)

    def adj_run(state, adj_arrays, adj_scalars):
        return run(adj.op, state, adj_arrays, adj_scalars, 1,
                   d_w=adw, n_f=anf, fused=afu, acc_dtype=acc_dtype)

    def start(ctx, gc, arrays):
        """The first cotangent (zeros for an output nobody read), the
        adjoint streams, and the gradient buffer of the streams."""
        shape, dtype, device = ctx.grid
        G = gc if gc is not None else torch.zeros(shape, dtype=dtype,
                                                  device=device)
        adj_arrays, adj_scalars = adj.map_coeffs(arrays, scalars)
        g_arrays = (torch.zeros(arrays.shape, dtype=arrays.dtype,
                                device=arrays.device)
                    if has_arrays and ctx.needs_input_grad[2] else None)
        return G, adj_arrays, adj_scalars, g_arrays

    class FirstOrder(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cur, prev, arrays):
            ctx.set_materialize_grads(False)
            ctx.grid = (cur.shape, cur.dtype, cur.device)
            if arrays is not None:
                arrays = arrays.contiguous()
            if not (has_arrays and ctx.needs_input_grad[2]):
                ctx.save_for_backward(arrays)
                return fwd_run((cur, prev), arrays, n_steps)
            # variable coefficients: stack the per-step input states
            curs, carry = [], (cur, prev)
            for _ in range(n_steps):
                curs.append(carry[0])
                carry = fwd_run(carry, arrays, 1)
            ctx.save_for_backward(arrays, *curs)
            return carry

        @staticmethod
        def backward(ctx, gc, gp):
            arrays, *curs = ctx.saved_tensors
            G, adj_arrays, adj_scalars, g_arrays = start(ctx, gc, arrays)
            P = gp
            for t in range(n_steps - 1, -1, -1):
                ghat = _zero_frame(G, r)
                g_new = adj_run((ghat, ghat), adj_arrays, adj_scalars)[0]
                _frame_shell(adj, adj_arrays, adj_scalars, ghat, out=g_new)
                _add_frame(g_new, r, G)
                if P is not None:
                    g_new += P
                if g_arrays is not None:
                    _coeff_grads(op, curs[t], ghat, arrays, scalars,
                                 out=g_arrays)
                G, P = g_new, None
            return (G if ctx.needs_input_grad[0] else None,
                    torch.zeros_like(G) if ctx.needs_input_grad[1] else None,
                    g_arrays)

    class SecondOrder(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cur, prev, arrays):
            ctx.set_materialize_grads(False)
            ctx.grid = (cur.shape, cur.dtype, cur.device)
            if arrays is not None:
                arrays = arrays.contiguous()
            out = fwd_run((cur, prev), arrays, n_steps)
            ctx.save_for_backward(out[0], out[1], arrays)   # O(1) residuals
            return out

        @staticmethod
        def backward(ctx, gc, gp):
            u, v, arrays = ctx.saved_tensors             # (U_N, U_{N-1})
            G, adj_arrays, adj_scalars, g_arrays = start(ctx, gc, arrays)
            P = gp if gp is not None else torch.zeros_like(G)
            for _ in range(n_steps):
                ghat = _zero_frame(G, r)
                g_new = adj_run((ghat, -P), adj_arrays, adj_scalars)[0]
                _frame_shell(adj, adj_arrays, adj_scalars, ghat, out=g_new)
                _add_frame(g_new, r, G, P)
                # time-symmetric reconstruction: the forward kernel on the
                # swapped state yields U_{t-2} from (U_t, U_{t-1})
                u_back = fwd_run((v, u), arrays, 1)[0]
                if g_arrays is not None:
                    _coeff_grads(op, v, ghat, arrays, scalars, out=g_arrays)
                u, v, G, P = v, u_back, g_new, -ghat
            # pull back through the entry frame sync (prev's frame := cur's)
            _add_frame(G, r, P)
            return (G if ctx.needs_input_grad[0] else None,
                    _zero_frame(P, r) if ctx.needs_input_grad[1] else None,
                    g_arrays)

    return SecondOrder if op.time_order == 2 else FirstOrder


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def resolve_adjoint_plan(spec: StencilSpec, grid_shape, word_bytes: int = 4,
                         batch: int = 1) -> tuple[MWDPlan, str]:
    """Plan for the gradient launches of `spec`: registry-first, ``vjp`` key.

    The registry is keyed on the adjoint operator (its own structural
    fingerprint) under the ``vjp`` variant, so a tuned adjoint plan never
    collides with the forward entry; a miss falls back to the model score
    of the adjoint op, whose stream count counts the transported
    coefficients. Returns ``(plan, source)``.
    """
    from repro_torch.core import registry
    return registry.resolve_plan(ir.adjoint(spec).op, tuple(grid_shape),
                                 word_bytes=word_bytes, devices_x=1,
                                 batch=batch, variant="vjp")


def _plans(spec, state, d_w, n_f, fused, plan, batch=1):
    """-> ((d_w, n_f, fused) forward, (d_w, n_f, fused) adjoint)."""
    fwd = (d_w, n_f, fused)
    if plan is None:
        return fwd, fwd
    if isinstance(plan, MWDPlan):
        fwd = (plan.d_w, plan.n_f, plan.fused)
        return fwd, fwd               # same radius, same 2R | d_w constraint
    if plan != "auto":
        raise ValueError(f"plan must be an MWDPlan, 'auto' or None, "
                         f"got {plan!r}")
    from repro_torch.core import registry
    cur = state[0]
    word = cur.element_size()
    grid = tuple(cur.shape[-3:])
    fp, _ = registry.resolve_plan(spec, grid, word_bytes=word, devices_x=1,
                                  batch=batch)
    ap, _ = resolve_adjoint_plan(spec, grid, word_bytes=word, batch=batch)
    return (fp.d_w, fp.n_f, fp.fused), (ap.d_w, ap.n_f, ap.fused)


def mwd_diff(spec: StencilSpec, state, coeffs, n_steps: int,
             d_w: int = 8, n_f: int = 2, fused: bool = True,
             plan: MWDPlan | str | None = None, dtype=None, acc="auto"):
    """Differentiable fused MWD advance: `ops.mwd` with a structural VJP.

    Forward-identical to `ops.mwd` (the same K1 launches, the same plan
    semantics); the backward pass runs the derived adjoint operator through
    K1 (see the module docstring). Gradients flow to the solution levels
    and the per-cell coefficient streams; scalar coefficients are static.

    plan="auto" resolves the forward plan registry-first as `ops.mwd` does
    and the gradient launches' plan under the ``vjp`` key
    (`resolve_adjoint_plan`); an explicit `MWDPlan` serves both directions
    (the adjoint has the op's radius, so the same constraints apply).
    """
    if dtype is not None:
        dt = precision.parse_dtype(dtype)
        state = tuple(s.to(dt) for s in state)
    if n_steps == 0:
        return state[0], state[1]
    fwd_p, adj_p = _plans(spec, state, d_w, n_f, fused, plan)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    scalars = tuple(float(x) for x in scalars)
    if dtype is not None and arrays is not None:
        arrays = arrays.to(dt)
    acc_dt = precision.resolve_acc(state[0].dtype, acc)
    fn = _diff_core(spec, scalars, n_steps, fwd_p, adj_p, acc_dt,
                    batched=False)
    return fn.apply(state[0], state[1], arrays)


def mwd_diff_batched(spec: StencilSpec, states, coeffs, n_steps: int,
                     d_w: int = 8, n_f: int = 2, fused: bool = True,
                     plan: MWDPlan | str | None = None, dtype=None,
                     acc="auto"):
    """Differentiable batched MWD advance (B grids, one launch, one VJP).

    `states` is a stacked ``(cur, prev)`` pair of ``(B, nz, ny, nx)``
    tensors or a sequence of B per-request pairs; `coeffs` follows
    `ops.mwd_batched`: a list of B packed sets or one shared set (whose
    streams then receive the gradient summed over the batch). Returns
    batched ``(cur, prev)`` and differentiates like `mwd_diff` with a
    leading batch axis everywhere.
    """
    dt = precision.parse_dtype(dtype) if dtype is not None else None
    if (isinstance(states, (tuple, list)) and len(states) == 2
            and getattr(states[0], "ndim", 0) == 4):
        cur, prev = states
    else:
        cur = torch.stack([s[0] for s in states])
        prev = torch.stack([s[1] for s in states])
    if dt is not None:
        cur, prev = cur.to(dt), prev.to(dt)
    b = cur.shape[0]
    if isinstance(coeffs, list):
        if len(coeffs) != b:
            raise ValueError(f"{spec.name}: got {len(coeffs)} coefficient "
                             f"sets for a batch of {b}")
        arrays, scalars = ir.split_coeffs_batch(spec, coeffs)
        if arrays is not None:
            arrays = torch.stack(arrays)
    else:
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        scalars = tuple(float(x) for x in scalars)
        if arrays is not None:
            arrays = arrays.expand((b,) + tuple(arrays.shape))
    if dt is not None and arrays is not None:
        arrays = arrays.to(dt)
    if n_steps == 0:
        return cur, prev
    fwd_p, adj_p = _plans(spec, (cur, prev), d_w, n_f, fused, plan, batch=b)
    acc_dt = precision.resolve_acc(cur.dtype, acc)
    fn = _diff_core(spec, scalars, n_steps, fwd_p, adj_p, acc_dt,
                    batched=True)
    return fn.apply(cur, prev, arrays)
