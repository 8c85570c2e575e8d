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
* `run_kernel` launches ``csrc/fused.cu`` once per pass: one CTA per (z, y)
  block and x tile of `TilePlan.bx` columns, x haloed like z and y, each
  level of the pass streamed plane by plane through shared-memory z-rings
  (see the source's notes). `choose_tile` picks the x tile, the y tile (the
  block, or sub-tiles of it where a block that tall fits no layout), the
  threads, the ring layout and the planes a step; it is the one host copy
  of the shared-memory layout, which the launcher, the chip check and the
  CPU mirror of the kernel read. A pass of more steps than any layout holds
  runs as several launches (`launch_steps`). It takes CUDA tensors only and
  raises on anything else.

The two agree bit for bit: a valid centre cell never depends on a pad cell
or on a stale halo cell, and both evaluate the same `ir.sweep_region`
arithmetic. The dispatch is by the tensors' device and nothing else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import ir, trace
from repro_torch.core import stencils as st
from repro_torch.kernels import _build
from repro_torch.kernels._host import (TYPE_CODES, check_inputs,
                                       check_kernel_inputs, edge_pad,
                                       hoist_groups, op_tables, ptr)

LAUNCHES = trace.counter("k3.launches")

# Hopper (sm_90, the kernels' only target): dynamic shared memory one block
# may opt into, shared memory of one SM, what the runtime reserves per
# block, and the threads one SM's 65,536 registers hold at the kernel's 64
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024
THREADS_PER_SM = 1_024
MAX_THREADS = 1_024        # threads per CTA (FUSED_MAX_THREADS)
STATIC_SMEM = 2_560        # the kernel's per-CTA tables (FUSED_STATIC_SMEM)
MAX_LEVELS = 32            # steps one launch takes (FUSED_MAX_LEVELS)
MAX_PLANES = 2             # planes a step (FUSED_MAX_PLANES)
LOAD_AHEAD = 2             # steps of cur's planes loaded early
BX_CHOICES = (128, 64, 32, 16, 8)   # x tile widths, multiples of 16 bytes


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class Ring:
    """One z-ring of planes in a CTA's shared memory (``csrc/fused.cu``).

    Plane k of the ring's level sits in slot ``k % depth``; within a slot,
    grid cell (y, x) of the CTA whose centre starts at (cy, cx) sits at
    ``(y - (cy - my)) * width + x - (cx - mx)``. `base` is the ring's byte
    offset in the dynamic shared memory, `tab` the first int of its
    per-slot tap table.
    """

    mx: int
    my: int
    width: int
    height: int
    depth: int
    base: int
    tab: int

    @property
    def plane(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How K3 tiles one launch, and the shared memory that takes.

    A CTA's centre is ``bx`` columns by ``ty`` rows (``ty`` the caller's
    ``by``, or a sub-tile of that block) by the caller's ``bz`` planes, and
    it advances ``planes`` planes a step. `rings[s]` holds level s (0: cur)
    for s < t_block, or None where the level is not kept: level 0 under the
    ``cur-in-place`` layout, read through L1/L2 from the input instead. The
    tap tables come first, then the rings.
    """

    bx: int
    ty: int
    threads: int
    planes: int
    hoist: int                # coefficient groups whose loads go first
    layout: str               # "all-rings" or "cur-in-place"
    rings: tuple
    tab_ints: int
    smem_bytes: int

    @property
    def ctas_per_sm(self) -> int:
        """CTAs one SM holds by shared memory and registers."""
        return min(SMEM_PER_SM // (self.smem_bytes + STATIC_SMEM
                                   + SMEM_RESERVED),
                   THREADS_PER_SM // self.threads)

    @property
    def fits(self) -> bool:
        """Whether one block holds the layout beside the static tables."""
        return self.smem_bytes + STATIC_SMEM <= SMEM_PER_BLOCK


def tile_layout(spec: st.StencilSpec, t_block: int, ty: int, bx: int,
                elem: int, *, layout: str, threads: int,
                planes: int = 1) -> TilePlan:
    """The shared-memory layout of one CTA for a given (ty, bx) tile.

    Level s < t_block keeps a ring of ``2R + planes`` planes over its box,
    the CTA's centre widened by ``m = (t_block - s) * R`` on every side
    (level 0, whose planes are loaded `LOAD_AHEAD` steps early,
    ``2R + planes * (1 + LOAD_AHEAD)`` planes, its rows aligned to 16 bytes
    so they stream in 16 bytes at a time). The kernel instance hoists the
    loads of the first 0, 8 or 16 coefficient groups, the fewest that cover
    the op's; two planes a step are built only for level 0 in place and no
    hoisted loads.
    """
    if layout not in ("all-rings", "cur-in-place"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if not 1 <= planes <= MAX_PLANES:
        raise ValueError(f"the fused kernel steps 1 to {MAX_PLANES} planes "
                         f"at a time, got {planes}")
    if not 32 <= threads <= MAX_THREADS or threads % 32:
        raise ValueError(f"the fused kernel takes 32 to {MAX_THREADS} "
                         f"threads in whole warps, got {threads}")
    r, e, n_taps = spec.radius, 16 // elem, len(spec.taps)
    shapes = {}
    for s in range(1 if layout == "cur-in-place" else 0, t_block):
        m = (t_block - s) * r
        if s == 0:
            mx = _up(m, e)
            shapes[s] = (mx, m, _up(mx + bx + m, e), ty + 2 * m,
                         2 * r + planes * (1 + LOAD_AHEAD))
        else:
            shapes[s] = (m, m, bx + 2 * m, ty + 2 * m, 2 * r + planes)
    tab_ints = sum(d for *_, d in shapes.values()) * n_taps
    off, tab = _up(4 * tab_ints, 16), 0
    rings = [None] * t_block
    for s, (mx, my, w, h, d) in shapes.items():
        rings[s] = Ring(mx, my, w, h, d, off, tab)
        off += _up(d * h * w * elem, 16)
        tab += d * n_taps
    hoist = hoist_groups(spec)
    if planes > 1 and (layout != "cur-in-place" or hoist):
        raise ValueError("the fused kernel steps two planes at a time only "
                         "with level 0 in place and no array-coefficient "
                         "group")
    return TilePlan(bx, ty, threads, planes, hoist, layout, tuple(rings),
                    tab_ints, off)


def sub_tiles(by: int) -> list[int]:
    """The y tiles K3 may split a block of ``by`` rows into, tallest first:
    by, then halved (rounded up) down to one row."""
    out = [by]
    while out[-1] > 1:
        out.append(-(-out[-1] // 2))
    return out


def choose_tile(spec: st.StencilSpec, t_block: int, by: int, nx: int,
                elem: int) -> TilePlan:
    """K3's own choice of x tile, y tile, threads, ring layout and planes.

    Measured at 512^3 x 8 steps, t_block = 4, bz = by = 16, f32 on an H100
    (``chip_smoke.py --sweep-k3``, PERF.md): what pays is residency, four
    CTAs of 256 threads per SM, then the widest x tile, which cuts the
    redundant x-halo updates. So: an op without coefficient streams reads
    level 0 in place (its L1 then serves cur alone), one with them keeps
    every level in a ring; the widest x tile of `BX_CHOICES` (no wider
    than the grid needs) that leaves four CTAs per SM, 256 threads each,
    one plane a step. Where none does (the 25-point ops: one CTA per SM),
    the widest x tile that fits one block in either layout, 1024 threads,
    and two planes a step where they fit with level 0 in place and no
    array-coefficient group (measured faster at 25pt-const; slower at four
    CTAs per SM, and at 25pt-var, whose hoisted loads then spill). Where no
    x tile fits a block of ``by`` rows, the same at
    the tallest y sub-tile of the block that fits (`sub_tiles`; unmeasured).
    Raises if no layout fits even at one row.
    """
    if not 1 <= t_block <= MAX_LEVELS:
        raise ValueError(f"the fused kernel takes 1 <= t_block <= "
                         f"{MAX_LEVELS}, got {t_block}")
    widths = [b for b in BX_CHOICES if b <= max(_up(nx, 8), BX_CHOICES[-1])]
    first = "all-rings" if spec.n_coeff_arrays else "cur-in-place"
    layouts = (first, "cur-in-place" if spec.n_coeff_arrays else "all-rings")

    def plan(layout, bx, threads, ty=by, planes=1):
        return tile_layout(spec, t_block, ty, bx, elem, layout=layout,
                           threads=threads, planes=planes)

    best = next((p for bx in widths for p in [plan(first, bx, 256)]
                 if p.ctas_per_sm >= 4), None)
    if best is not None:
        return best
    for ty in sub_tiles(by):
        fits = [p for bx in widths for layout in layouts
                for p in [plan(layout, bx, MAX_THREADS, ty)] if p.fits]
        if fits:
            best = fits[0]
            if best.layout == "cur-in-place" and best.hoist == 0:
                two = plan(best.layout, best.bx, MAX_THREADS, ty, planes=2)
                best = two if two.fits else best
            return best
    raise ValueError(
        f"{spec.name}: no x tile fits the fused kernel's rings in "
        f"{SMEM_PER_BLOCK} bytes of shared memory at t_block={t_block}, "
        f"even at y tiles of one row, {elem}-byte words")


def launch_steps(spec: st.StencilSpec, t_block: int, by: int, nx: int,
                 elem: int) -> list[int]:
    """Steps of each K3 launch of one pass of ``t_block`` steps.

    ``[t_block]`` where `choose_tile` has a layout for it; else launches of
    the most steps one holds (the last shorter), each of which writes the
    next launch's (cur, prev). The values do not depend on how the steps
    are split, so neither do the bits; one step always fits (no ring).
    """
    for t in range(min(t_block, MAX_LEVELS), 1, -1):
        try:
            choose_tile(spec, t, by, nx, elem)
        except ValueError:
            continue
        return pass_lengths(t_block, t)
    return [1] * t_block


def window_bytes(spec: st.StencilSpec, shape, t_block: int, bz: int, by: int,
                 bx: int, elem: int, ty: int | None = None) -> int:
    """HBM bytes of one launch if each tile reads its own window once.

    Per (bz, ty, bx) tile, clipped to the grid and, in y, to its block of
    ``by`` rows (``ty``: the kernel's y tile, by default the block):
    cur over the level-0 box (the centre widened by ``R * t_block``), prev
    (2nd order) and every coefficient stream over the level-1 box, and both
    centres written. No reuse between tiles is assumed, so it is an upper
    estimate of the traffic; the compulsory bytes are the lower one.
    """
    def spans(n, b, t):
        return [(c, min(c + t, c0 + b, n)) for c0 in range(0, n, b)
                for c in range(c0, min(c0 + b, n), t)]

    axes = [spans(shape[0], bz, bz), spans(shape[1], by, ty or by),
            spans(shape[2], bx, bx)]

    def cells(m):
        ext = [sum(min(e + m, n) - max(c - m, 0) for c, e in tiles)
               for n, tiles in zip(shape, axes)]
        return ext[0] * ext[1] * ext[2]

    r, g = spec.radius, spec.radius * t_block
    reads = cells(g) + cells(g - r) * ((spec.time_order == 2)
                                       + spec.n_coeff_arrays)
    return (reads + 2 * shape[0] * shape[1] * shape[2]) * elem


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
    """The built ``csrc/fused.cu`` with its launchers' C signatures declared."""
    lib = _build.load("fused").lib
    lib.fused_pass.restype = ctypes.c_int
    lib.fused_pass.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fused_config.restype = ctypes.c_int
    lib.fused_config.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.fused_error_string.restype = ctypes.c_char_p
    lib.fused_error_string.argtypes = [ctypes.c_int]
    return lib


def _geometry(spec: st.StencilSpec, shape, t_block: int, bz: int, by: int,
              plan: TilePlan) -> np.ndarray:
    """The launcher's ``geo`` table (see ``csrc/fused.cu``)."""
    head = [*shape, bz, by, plan.bx, plan.ty, spec.radius, t_block,
            plan.threads, plan.planes, int(plan.layout == "cur-in-place"),
            spec.n_coeff_arrays, plan.smem_bytes, plan.tab_ints, LOAD_AHEAD,
            plan.hoist]
    rings = [v for ring in plan.rings
             for v in ([0] * 7 if ring is None else
                       [ring.mx, ring.my, ring.width, ring.height,
                        ring.depth, ring.base, ring.tab])]
    return np.asarray(head + rings, np.int64)


def _plan(spec: st.StencilSpec, cur, t_block: int, bz: int,
          by: int) -> tuple[TilePlan, np.ndarray]:
    plan = choose_tile(spec, t_block, by, cur.shape[2], cur.element_size())
    return plan, _geometry(spec, cur.shape, t_block, bz, by, plan)


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused kernel {what} failed ({rc}): "
                           f"{lib.fused_error_string(rc).decode()}")


def kernel_config(spec: st.StencilSpec, cur, t_block: int, *, bz: int = 16,
                  by: int = 16) -> dict:
    """The launch configuration of a pass over CUDA grid `cur`.

    Keys: launches (`launch_steps`: the steps of each launch), then of the
    first launch: bx, ty (rows of a CTA's centre), threads, planes (a
    step), layout, smem_bytes (dynamic shared memory per CTA), ctas (CTAs
    in the grid), resident (CTAs per SM, by the occupancy API) and hoist
    (groups whose coefficient loads are issued together, which names the
    kernel instance).
    """
    dev = check_kernel_inputs("fused", [cur])
    nz, ny, nx = cur.shape
    steps = launch_steps(spec, t_block, by, nx, cur.element_size())
    plan, geo = _plan(spec, cur, steps[0], bz, by)
    lib = _fused_lib()
    out = np.zeros(1, np.int32)
    _raise(lib, lib.fused_config(TYPE_CODES[cur.dtype], ptr(geo), dev.index,
                                 ptr(out)), "configuration")
    ctas = (-(-nz // bz) * -(-ny // by) * -(-by // plan.ty)
            * -(-nx // plan.bx))
    return {"launches": steps, "bx": plan.bx, "ty": plan.ty,
            "threads": plan.threads, "planes": plan.planes,
            "layout": plan.layout, "smem_bytes": plan.smem_bytes,
            "ctas": ctas, "resident": int(out[0]), "hoist": plan.hoist}


def run_kernel(spec: st.StencilSpec, state, arrays, scalars, t_block: int, *,
               bz: int = 16, by: int = 16):
    """One pass on the CUDA kernel: state -> state, both freshly allocated;
    one launch per entry of `launch_steps`."""
    cur, prev = state
    dev = check_kernel_inputs(
        "fused", [cur, prev] + ([arrays] if arrays is not None else []))
    nz, ny, nx = cur.shape
    taps, groups, values = op_tables(spec, scalars, ny * nx, nx)
    taps3 = np.asarray([t.offset for _, members in spec.groups
                        for t in members], np.int32)
    lib = _fused_lib()
    for tb in launch_steps(spec, t_block, by, nx, cur.element_size()):
        plan, geo = _plan(spec, cur, tb, bz, by)
        new_cur, new_prev = torch.empty_like(cur), torch.empty_like(cur)
        rc = lib.fused_pass(
            TYPE_CODES[cur.dtype], new_cur.data_ptr(), new_prev.data_ptr(),
            cur.data_ptr(), prev.data_ptr(),
            arrays.data_ptr() if arrays is not None else None, ptr(geo),
            ptr(taps), ptr(taps3), len(taps), ptr(groups), ptr(values),
            len(spec.groups), spec.time_order, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        _raise(lib, rc, "launch")
        LAUNCHES.count += 1
        cur, prev = new_cur, new_prev
    return cur, prev


def fused_pass(spec: st.StencilSpec, state, arrays, scalars, t_block: int, *,
               bz: int = 16, by: int = 16):
    """Advance t_block steps in one fused pass: state -> state.

    `arrays` is the op's stacked ``(A, z, y, x)`` coefficient stream (or
    None) and `scalars` its scalar tuple; a block owns ``bz`` z-rows and
    ``by`` y-rows of the grid (the kernel also splits x, `choose_tile`).
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
