"""K2: one spatially blocked sweep step, as a CUDA kernel plus its plain version.

The port of `repro.kernels.stencil_sweep`, the paper's "optimal spatial
blocking" baseline: `sweep_step` advances one time step, state ->
``(new, cur)``, and `run_sweep` loops it. The reference edge-pads every
stream only to give its Pallas DMA windows a fixed shape; no interior cell
reads beyond the grid, so neither executor here pads.

* `run_kernel` launches ``csrc/sweep.cu`` once per step (a block per
  ``bz`` z-rows of a y-range, threads along x), out of place, writing every
  cell of `new`. It takes CUDA tensors only and raises on anything else.
* `run_plain` is one step of `ir.sweep_region` over the interior with the
  frame copied from cur (`ir.make_sweep`). The CPU path uses it; on the
  card only the chip check calls it, to hold the kernel against it.

The dispatch is by the tensors' device and nothing else, as in
`stencil_mwd.run`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core import stencils as st
from repro_torch.kernels import _build
from repro_torch.kernels._host import (LaunchCounter, TYPE_CODES,
                                       check_inputs, check_kernel_inputs,
                                       op_tables, ptr)

LAUNCHES = LaunchCounter()


def _check(spec: st.StencilSpec, state, arrays, bz: int) -> None:
    cur, prev = state
    if cur.ndim != 3:
        raise ValueError(f"the sweep wants (nz, ny, nx) grids, got shape "
                         f"{tuple(cur.shape)}")
    if bz < 1:
        raise ValueError(f"bz must be >= 1, got {bz}")
    check_inputs(spec, cur, prev, arrays)


def run_plain(spec: st.StencilSpec, state, arrays, scalars):
    """The plain PyTorch version of one step: ``(new, cur)``."""
    cur, prev = state
    return ir.make_sweep(spec)(cur, prev, arrays, scalars), cur


@functools.lru_cache(maxsize=None)
def _sweep_lib() -> ctypes.CDLL:
    """The built ``csrc/sweep.cu`` with its launcher's C signature declared."""
    lib = _build.load("sweep").lib
    lib.sweep_step.restype = ctypes.c_int
    lib.sweep_step.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.sweep_error_string.restype = ctypes.c_char_p
    lib.sweep_error_string.argtypes = [ctypes.c_int]
    return lib


def run_kernel(spec: st.StencilSpec, state, arrays, scalars, *, bz: int = 8):
    """One step on the CUDA kernel: ``(new, cur)``, `new` freshly allocated."""
    cur, prev = state
    dev = check_kernel_inputs(
        "sweep", [cur, prev] + ([arrays] if arrays is not None else []))
    nz, ny, nx = cur.shape
    taps, groups, values = op_tables(spec, scalars, ny * nx, nx)
    geo = np.asarray([nz, ny, nx, bz], np.int64)
    new = torch.empty_like(cur)
    lib = _sweep_lib()
    rc = lib.sweep_step(
        TYPE_CODES[cur.dtype], new.data_ptr(), cur.data_ptr(),
        prev.data_ptr(), arrays.data_ptr() if arrays is not None else None,
        ptr(geo), ptr(taps), len(taps), ptr(groups), ptr(values),
        len(spec.groups), spec.time_order, spec.radius, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed ({rc}): "
                           f"{lib.sweep_error_string(rc).decode()}")
    LAUNCHES.count += 1
    return new, cur


def sweep_step(spec: st.StencilSpec, state, arrays, scalars, *, bz: int = 8):
    """One interior-update time step: state -> ``(new, cur)``.

    `arrays` is the op's stacked ``(A, z, y, x)`` coefficient stream (or
    None) and `scalars` its scalar tuple; `bz` is the number of z-rows a
    kernel block owns.
    """
    _check(spec, state, arrays, bz)
    if state[0].is_cuda:
        return run_kernel(spec, state, arrays, scalars, bz=bz)
    return run_plain(spec, state, arrays, scalars)


def run_sweep(spec: st.StencilSpec, state, arrays, scalars, n_steps: int, *,
              bz: int = 8):
    """Advance n_steps as independent single-sweep steps (one launch each)."""
    for _ in range(n_steps):
        state = sweep_step(spec, state, arrays, scalars, bz=bz)
    return state
