"""Public entry points of the port's stencil kernels.

Every entry point takes ``(spec, state, coeffs, n_steps [, plan params])``
with `coeffs` in the op's packed convention (`core.ir.split_coeffs`). The
tensors' device picks the executor: CUDA tensors run a hand-written kernel,
CPU tensors its plain PyTorch version. Problems are built on a device with
`core.stencils.make_problem(..., device=...)`.

The four methods of the reference, with their kernels:

* `naive`: the un-blocked oracle, plain PyTorch on any device;
* `spatial`: spatial blocking, one K2 launch per step
  (`kernels.stencil_sweep`, ``csrc/sweep.cu``);
* `ghostzone`: ghost-zone temporal blocking, one K3 launch per pass of
  ``t_block`` steps (`kernels.stencil_fused`, ``csrc/fused.cu``);
* `mwd`: the paper's MWD advance, one K1 launch per diamond row
  (`kernels.stencil_mwd`, ``csrc/mwd.cu``).

`mwd_diff` / `mwd_diff_batched` are `mwd` / `mwd_batched` with a
structural backward pass (`kernels.adjoint`): K1 on the adjoint operator.
"""

from __future__ import annotations

import torch

from repro_torch.core import ir, precision
from repro_torch.core.mwd import MWDPlan
from repro_torch.core.stencils import StencilSpec
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import stencil_fused, stencil_mwd, stencil_sweep
from repro_torch.kernels.adjoint import mwd_diff, mwd_diff_batched  # noqa: F401
# mwd_diff / mwd_diff_batched: forward-identical to mwd / mwd_batched with a
# structural VJP whose backward runs K1 on the adjoint operator
# (repro_torch.kernels.adjoint); `launch.fit` drives them.

ref = _ref


def resolve_plan(spec: StencilSpec, state, plan, batch: int = 1) -> MWDPlan:
    """Turn `ops.mwd`'s `plan=` argument into a concrete `MWDPlan`.

    `plan` may be an `MWDPlan` (used as-is) or ``"auto"``, which resolves
    registry-first (`core.registry.resolve_plan`) by the operator's
    structural fingerprint, the grid shape, word size and batch size, and
    the hardware fingerprint: a tuned entry, else a plan tuned under
    another device spec and translated, else the model-scored tuner.
    Single-device launches resolve with ``devices_x=1``; `batch` > 1
    selects the ``b<B>`` key.
    """
    if isinstance(plan, MWDPlan):
        return plan
    if plan != "auto":
        raise ValueError(f"plan must be an MWDPlan or 'auto', got {plan!r}")
    from repro_torch.core import registry
    cur = state[0]
    resolved, _source = registry.resolve_plan(
        spec, tuple(cur.shape[-3:]), word_bytes=cur.element_size(),
        devices_x=1, batch=batch)
    return resolved


def _split_coeffs(spec: StencilSpec, coeffs):
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    return arrays, tuple(float(x) for x in scalars)


def spatial(spec: StencilSpec, state, coeffs, n_steps: int, bz: int = 8):
    """Optimal spatial blocking baseline: n_steps single-sweep steps."""
    arrays, scalars = _split_coeffs(spec, coeffs)
    return stencil_sweep.run_sweep(spec, state, arrays, scalars, n_steps,
                                   bz=bz)


def ghostzone(spec: StencilSpec, state, coeffs, n_steps: int,
              t_block: int = 4, bz: int = 16, by: int = 16):
    """Ghost-zone fused temporal blocking: passes of t_block steps."""
    arrays, scalars = _split_coeffs(spec, coeffs)
    return stencil_fused.run_fused(spec, state, arrays, scalars, n_steps,
                                   t_block=t_block, bz=bz, by=by)


def mwd(spec: StencilSpec, state, coeffs, n_steps: int,
        d_w: int = 8, n_f: int = 2, fused: bool = True,
        plan: MWDPlan | str | None = None, dtype=None, acc="auto"):
    """Multi-threaded wavefront diamond blocking: advance `n_steps`.

    fused=True runs every diamond row on one pair of padded grids;
    fused=False materializes fresh grids per row (the reference's per-row
    mode). Both are bitwise equal.

    plan: an `MWDPlan` overriding (d_w, n_f, fused), or ``"auto"``
    (`resolve_plan`).

    dtype: optional stream dtype (e.g. ``"bf16"``); state and coefficient
    streams are cast before the launch. acc: accumulator policy,
    ``"auto"`` (f32 for sub-32-bit streams), ``"native"`` or a dtype.
    """
    if dtype is not None:
        dt = precision.parse_dtype(dtype)
        state = tuple(s.to(dt) for s in state)
    if plan is not None:
        p = resolve_plan(spec, state, plan)
        d_w, n_f, fused = p.d_w, p.n_f, p.fused
    arrays, scalars = _split_coeffs(spec, coeffs)
    if dtype is not None and arrays is not None:
        arrays = arrays.to(dt)
    acc_dt = precision.resolve_acc(state[0].dtype, acc)
    return stencil_mwd.mwd_run(spec, state, arrays, scalars, n_steps,
                               d_w=d_w, n_f=n_f, fused=fused,
                               acc_dtype=acc_dt)


def mwd_batched(spec: StencilSpec, states, coeffs, n_steps: int,
                d_w: int = 8, n_f: int = 2, fused: bool = True,
                plan: MWDPlan | str | None = None, dtype=None, acc="auto"):
    """Advance B independent same-shaped grids in the same launches.

    `states` is a sequence of B ``(cur, prev)`` pairs or an already-stacked
    pair of ``(B, nz, ny, nx)`` tensors; `coeffs` is a **list** of B packed
    coefficient sets (array streams batch, scalars must be shared) or one
    packed set applied to every request. Returns batched ``(cur, prev)``,
    bitwise equal to a per-item `mwd` loop.

    A batch whose members disagree on dtype is refused unless `dtype=` is
    given: stacking would silently promote every member.
    """
    dt = precision.parse_dtype(dtype) if dtype is not None else None
    if (isinstance(states, (tuple, list)) and len(states) == 2
            and getattr(states[0], "ndim", 0) == 4):
        cur, prev = states
        if dt is not None:
            cur, prev = cur.to(dt), prev.to(dt)
    else:
        member_dts = ({s[0].dtype for s in states}
                      | {s[1].dtype for s in states})
        if dt is None and len(member_dts) > 1:
            raise ValueError(
                f"{spec.name}: mixed-dtype batch "
                f"{sorted(str(d) for d in member_dts)} — stacking would "
                f"silently promote; pass dtype= to cast explicitly or "
                f"batch per dtype")
        cur = torch.stack([s[0] for s in states])
        prev = torch.stack([s[1] for s in states])
        if dt is not None:
            cur, prev = cur.to(dt), prev.to(dt)
    b = cur.shape[0]
    if plan is not None:
        p = resolve_plan(spec, (cur[0],), plan, batch=b)
        d_w, n_f, fused = p.d_w, p.n_f, p.fused
    if isinstance(coeffs, list):        # per-request packed coefficients
        if len(coeffs) != b:
            raise ValueError(f"{spec.name}: got {len(coeffs)} coefficient "
                             f"sets for a batch of {b}")
        arrays, scalars = ir.split_coeffs_batch(spec, coeffs)
    else:                       # one packed set shared by the whole batch
        arrays, scalars = _split_coeffs(spec, coeffs)
        if arrays is not None:
            arrays = (arrays,) * b
    if arrays is not None:
        arrays = torch.stack(arrays)
        if dt is not None:
            arrays = arrays.to(dt)
    acc_dt = precision.resolve_acc(cur.dtype, acc)
    return stencil_mwd.mwd_run_batched(spec, (cur, prev), arrays, scalars,
                                       n_steps, d_w=d_w, n_f=n_f,
                                       fused=fused, acc_dtype=acc_dt)


def naive(spec: StencilSpec, state, coeffs, n_steps: int):
    """Un-blocked reference (paper Fig. 1a), plain PyTorch on any device."""
    return _ref.naive_steps(spec, state, coeffs, n_steps)


METHODS = {"naive": naive, "spatial": spatial, "ghostzone": ghostzone,
           "mwd": mwd}
