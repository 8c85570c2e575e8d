"""K3: ghost-zone temporal blocking, as a CUDA kernel plus its plain version.

The port of `repro.kernels.stencil_fused`: `fused_pass` advances
``t_block`` steps in one pass, state -> state, each (z, y) block working on
a window haloed by ``g = R * t_block`` and recomputing its halo; `run_fused`
loops passes, the last one short when ``t_block`` does not divide
``n_steps``.

* `run_plain` mirrors the reference's function: edge-padded windows,
  ``t_block`` sweeps per block with the Dirichlet frame mask restored after
  each, the un-haloed centre of both levels written to fresh tensors and
  spliced into cur's frame. The CPU path uses it; on the card only the chip
  check calls it, to hold the kernel against it.
* `run_kernel` launches ``csrc/fused.cu`` once per pass: a persistent grid
  of `BLOCKS_PER_SM` blocks per SM, each with two ping-pong windows of
  global scratch, windows clamped to the grid (see the source's notes). It
  takes CUDA tensors only and raises on anything else.

The two agree bit for bit: a valid centre cell never depends on a pad cell
or on a stale halo cell, and both evaluate the same `ir.sweep_region`
arithmetic. The dispatch is by the tensors' device and nothing else.
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
                                       edge_pad, op_tables, ptr)

LAUNCHES = LaunchCounter()

# persistent blocks per SM; each holds two windows of scratch
BLOCKS_PER_SM = 2


def _check(spec: st.StencilSpec, state, arrays, t_block: int, bz: int,
           by: int) -> None:
    cur, prev = state
    if cur.ndim != 3:
        raise ValueError(f"the fused pass wants (nz, ny, nx) grids, got "
                         f"shape {tuple(cur.shape)}")
    if t_block < 1 or bz < 1 or by < 1:
        raise ValueError(f"t_block, bz and by must be >= 1, got {t_block}, "
                         f"{bz}, {by}")
    check_inputs(spec, cur, prev, arrays)


def _frame_mask(n: int, pad: tuple[int, int], r: int, device):
    """Cells of one padded axis whose grid coordinate lies outside [r, n-r)."""
    i = torch.arange(pad[0] + n + pad[1], device=device) - pad[0]
    return (i < r) | (i >= n - r)


def run_plain(spec: st.StencilSpec, state, arrays, scalars, t_block: int, *,
              bz: int = 16, by: int = 16):
    """The plain PyTorch version of one pass, block by block: state -> state."""
    cur, prev = state
    r = spec.radius
    g = r * t_block
    nz, ny, nx = cur.shape
    nzp = -(-nz // bz) * bz
    nyp = -(-ny // by) * by
    pads = ((g, g + nzp - nz), (g, g + nyp - ny), (g, g))
    cur_p = edge_pad(cur, pads)
    prev_p = edge_pad(prev, pads) if spec.time_order == 2 else None
    arr_p = edge_pad(arrays, pads) if spec.n_coeff_arrays else None
    frame = (_frame_mask(nz, pads[0], r, cur.device)[:, None, None]
             | _frame_mask(ny, pads[1], r, cur.device)[None, :, None]
             | _frame_mask(nx, pads[2], r, cur.device)[None, None, :])
    sweep = ir.make_sweep(spec)
    cur_o = cur.new_empty((nzp, nyp, nx + 2 * g))
    prev_o = cur.new_empty((nzp, nyp, nx + 2 * g))
    for i in range(nzp // bz):
        for j in range(nyp // by):
            win = (slice(i * bz, i * bz + bz + 2 * g),
                   slice(j * by, j * by + by + 2 * g))
            w_frame = cur_p[win]
            # cur, then the loaded prev (2nd order) or a ping-pong buffer
            # that the first sweep fills before anything reads it
            bufs = [w_frame, prev_p[win] if prev_p is not None
                    else torch.empty_like(w_frame)]
            coeff = arr_p[(slice(None),) + win] if arr_p is not None else None
            mask = frame[win]
            for _ in range(t_block):
                new = sweep(bufs[0], bufs[1], coeff, scalars)
                bufs = [torch.where(mask, w_frame, new), bufs[0]]
            centre = (slice(i * bz, (i + 1) * bz), slice(j * by, (j + 1) * by))
            cur_o[centre] = bufs[0][g:g + bz, g:g + by]
            prev_o[centre] = bufs[1][g:g + bz, g:g + by]
    # splice: out (z, y) index == grid index; x carries the g-pad offset
    inner = (slice(r, nz - r), slice(r, ny - r), slice(r, nx - r))
    out_inner = (slice(r, nz - r), slice(r, ny - r), slice(g + r, g + nx - r))
    new_cur, new_prev = cur.clone(), cur.clone()
    new_cur[inner] = cur_o[out_inner]
    new_prev[inner] = prev_o[out_inner]
    return new_cur, new_prev


@functools.lru_cache(maxsize=None)
def _fused_lib() -> ctypes.CDLL:
    """The built ``csrc/fused.cu`` with its launcher's C signature declared."""
    lib = _build.load("fused").lib
    lib.fused_pass.restype = ctypes.c_int
    lib.fused_pass.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.fused_error_string.restype = ctypes.c_char_p
    lib.fused_error_string.argtypes = [ctypes.c_int]
    return lib


def _n_blocks(shape, bz: int, by: int, device) -> int:
    """Persistent blocks of one launch: a few per SM, at most one per tile."""
    nz, ny, _ = shape
    n_tiles = -(-nz // bz) * -(-ny // by)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(n_tiles, BLOCKS_PER_SM * sms)


def run_kernel(spec: st.StencilSpec, state, arrays, scalars, t_block: int, *,
               bz: int = 16, by: int = 16):
    """One pass on the CUDA kernel: state -> state, both freshly allocated."""
    cur, prev = state
    dev = check_kernel_inputs(
        "fused", [cur, prev] + ([arrays] if arrays is not None else []))
    nz, ny, nx = cur.shape
    halo = 2 * spec.radius * t_block
    blocks = _n_blocks(cur.shape, bz, by, dev)
    scratch = cur.new_empty(blocks * 2 * (bz + halo) * (by + halo) * nx)
    taps, groups, values = op_tables(spec, scalars, ny * nx, nx)
    win_taps = op_tables(spec, scalars, (by + halo) * nx, nx)[0].astype(
        np.int32)
    geo = np.asarray([nz, ny, nx, bz, by, t_block, blocks], np.int64)
    new_cur, new_prev = torch.empty_like(cur), torch.empty_like(cur)
    lib = _fused_lib()
    rc = lib.fused_pass(
        TYPE_CODES[cur.dtype], new_cur.data_ptr(), new_prev.data_ptr(),
        scratch.data_ptr(), cur.data_ptr(), prev.data_ptr(),
        arrays.data_ptr() if arrays is not None else None, ptr(geo),
        ptr(taps), ptr(win_taps), len(taps), ptr(groups), ptr(values),
        len(spec.groups), spec.time_order, spec.radius, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused kernel launch failed ({rc}): "
                           f"{lib.fused_error_string(rc).decode()}")
    LAUNCHES.count += 1
    return new_cur, new_prev


def fused_pass(spec: st.StencilSpec, state, arrays, scalars, t_block: int, *,
               bz: int = 16, by: int = 16):
    """Advance t_block steps in one fused pass: state -> state.

    `arrays` is the op's stacked ``(A, z, y, x)`` coefficient stream (or
    None) and `scalars` its scalar tuple; a block owns ``bz`` z-rows and
    ``by`` y-rows of the grid, all x.
    """
    _check(spec, state, arrays, t_block, bz, by)
    if state[0].is_cuda:
        return run_kernel(spec, state, arrays, scalars, t_block, bz=bz, by=by)
    return run_plain(spec, state, arrays, scalars, t_block, bz=bz, by=by)


def pass_lengths(n_steps: int, t_block: int) -> list[int]:
    """Steps of each pass of an n_steps advance: t_block, ..., then the rest."""
    if t_block < 1:
        raise ValueError(f"t_block must be >= 1, got {t_block}")
    full, rest = divmod(n_steps, t_block)
    return [t_block] * full + ([rest] if rest else [])


def run_fused(spec: st.StencilSpec, state, arrays, scalars, n_steps: int,
              t_block: int = 4, *, bz: int = 16, by: int = 16):
    """Advance n_steps in fused t_block-step passes (the last may be short)."""
    for tb in pass_lengths(n_steps, t_block):
        state = fused_pass(spec, state, arrays, scalars, tb, bz=bz, by=by)
    return state
