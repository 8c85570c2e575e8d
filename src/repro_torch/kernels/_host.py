"""Host-side pieces shared by the three kernel wrappers.

The launchers of ``csrc/mwd.cu``, ``csrc/sweep.cu`` and ``csrc/fused.cu``
share one C convention (``csrc/stencil_cell.cuh``): the stream type codes,
the operator passed as tap, group and value tables, and pointers as Python
ints. This module holds that convention, the input checks and the edge
padding the plain versions use.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import ir


# stream / accumulator type codes of stencil_cell.cuh
TYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
              torch.float16: 3}


def op_tables(op: ir.StencilOp, scalars, sz: int, sy: int):
    """Tap offsets, group descriptors and const values for a launcher.

    Tap offsets are linear in a layout with z stride `sz`, y stride `sy`
    and contiguous x, listed in `op.groups` order.
    """
    taps, groups, values = [], [], []
    for coeff, members in op.groups:
        taps += [t.dz * sz + t.dy * sy + t.dx for t in members]
        groups += [len(members), int(coeff.kind == "array"), coeff.index]
        values.append(scalars[coeff.index] if coeff.kind == "const" else 0.0)
    scale = op.scale
    groups += ([-1, 0] if scale is None
               else [int(scale.kind == "array"), scale.index])
    values.append(scalars[scale.index]
                  if scale is not None and scale.kind == "const" else 0.0)
    return (np.asarray(taps, np.int64), np.asarray(groups, np.int32),
            np.asarray(values, np.float64))


def _layout(op: ir.StencilOp) -> tuple:
    """An op's tap offsets in `op.groups` order, its group sizes and its
    groups' coefficient kinds."""
    return (tuple(t.offset for _, members in op.groups for t in members),
            tuple(len(members) for _, members in op.groups),
            tuple(coeff.kind for coeff, _ in op.groups))


@functools.lru_cache(maxsize=None)
def _star_layouts() -> dict:
    """K1's compile-time layouts by code (``Star<L>`` of
    ``csrc/stencil_cell.cuh``): the paper's four operators, the adjoints of
    the two 7-point ones (every offset negated) and 7pt-const's masked twin
    (its groups turned to streams)."""
    from repro_torch.core import padding
    paper = [ir.OPS[n] for n in ("7pt-const", "7pt-var", "25pt-const",
                                 "25pt-var")]
    ops = (paper + [ir.adjoint(op).op for op in paper[:2]]
           + [padding.masked_variant(paper[0])])
    return {_layout(op): code for code, op in enumerate(ops, 1)}


def star_layout(op: ir.StencilOp) -> int:
    """The code of K1's star instance for `op` (1-7), or 0 for the generic
    one.

    An op takes a star instance where its tap offsets, in `op.groups`
    order, its group sizes and its groups' coefficient kinds are those of a
    layout K1 compiles in: the paper's operators, their ``+mask`` twins and
    the 7-point adjoints. The time order, the scale, the streams' slots and
    the constants stay the op's own. Any other op, a reordered tap list or
    a const group among streams say, runs the generic instance; both give
    the same bits.
    """
    return _star_layouts().get(_layout(op), 0)


def hoist_groups(op: ir.StencilOp) -> int:
    """Array-coefficient groups whose loads a kernel instance issues
    together (update_cell's H): 0, 8 or 16, the fewest that cover the op's.
    """
    n = sum(c.kind == "array" for c, _ in op.groups)
    return 0 if n == 0 else 8 if n <= 8 else 16


def ptr(a: np.ndarray) -> ctypes.c_void_p:
    """A host numpy array as a launcher argument."""
    return ctypes.c_void_p(a.ctypes.data)


def check_inputs(op: ir.StencilOp, cur, prev, arrays) -> None:
    """Raise unless cur, prev and the coefficient streams fit together.

    Shapes may carry leading batch axes; `arrays` is ``(..., A, z, y, x)``
    or None.
    """
    if prev.shape != cur.shape or prev.dtype != cur.dtype:
        raise ValueError(f"cur {tuple(cur.shape)}/{cur.dtype} and prev "
                         f"{tuple(prev.shape)}/{prev.dtype} disagree")
    if arrays is not None:
        want = cur.shape[:-3] + (op.n_coeff_arrays,) + cur.shape[-3:]
        if tuple(arrays.shape) != tuple(want) or arrays.dtype != cur.dtype:
            raise ValueError(f"{op.name}: coefficient streams "
                             f"{tuple(arrays.shape)}/{arrays.dtype}, want "
                             f"{tuple(want)}/{cur.dtype}")
    for t in (prev,) + (() if arrays is None else (arrays,)):
        if t.device != cur.device:
            raise ValueError(f"tensors on {t.device} and {cur.device}")


def check_kernel_inputs(name: str, tensors) -> torch.device:
    """The common device, after checking the tensors a kernel will read.

    Raises unless every tensor is a contiguous CUDA tensor of one dtype the
    kernels are built for, on one device.
    """
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel wants CUDA tensors, got {dev}")
    if dt not in TYPE_CODES:
        raise ValueError(f"the {name} kernel has no {dt} variant")
    for t in tensors:
        if not t.is_contiguous() or t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} kernel inputs must be contiguous "
                             f"{dt} tensors on {dev}")
    return dev


def edge_pad(a: torch.Tensor, pads) -> torch.Tensor:
    """Edge-pad the trailing (z, y, x) axes; ``pads = ((lo, hi),) * 3``.

    The same values as ``jnp.pad(mode="edge")``, for any leading axes.
    """
    (z0, z1), (y0, y1), (x0, x1) = pads
    nz, ny, nx = a.shape[-3:]
    out = a.new_empty(a.shape[:-3] + (z0 + nz + z1, y0 + ny + y1,
                                      x0 + nx + x1))
    zs, ys = slice(z0, z0 + nz), slice(y0, y0 + ny)
    out[..., zs, ys, x0:x0 + nx] = a
    out[..., zs, ys, :x0] = a[..., :, :, :1]
    out[..., zs, ys, x0 + nx:] = a[..., :, :, -1:]
    out[..., zs, :y0, :] = out[..., zs, y0:y0 + 1, :]
    out[..., zs, y0 + ny:, :] = out[..., zs, y0 + ny - 1:y0 + ny, :]
    out[..., :z0, :, :] = out[..., z0:z0 + 1, :, :]
    out[..., z0 + nz:, :, :] = out[..., z0 + nz - 1:z0 + nz, :, :]
    return out
