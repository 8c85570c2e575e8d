"""K2: one spatially blocked sweep step, as a CUDA kernel plus its plain version.

The port of `repro.kernels.stencil_sweep`, the paper's "optimal spatial
blocking" baseline: `sweep_step` advances one time step, state ->
``(new, cur)``, and `run_sweep` loops it. The reference edge-pads every
stream only to give its Pallas DMA windows a fixed shape; no interior cell
reads beyond the grid, so neither executor here pads.

* `run_kernel` launches ``csrc/sweep.cu`` once per step: one CTA per (z
  chunk, y tile, x tile), streaming z through a shared-memory ring of cur's
  planes over its tile (see the source's notes), out of place, writing
  every cell of `new`. `choose_tile` picks the tile, threads, chunk (a
  whole multiple of the caller's `bz`), planes loaded ahead and L2
  prefetch from a plan measured per kind of op (`TILES`); `tile_layout` is
  the one host copy of the ring layout, which the launcher, the chip check
  and the CPU mirror of the kernel read. It takes CUDA tensors only and
  raises on anything else.
* `run_plain` is one step of `ir.sweep_region` over the interior with the
  frame copied from cur (`ir.make_sweep`). The CPU path uses it; on the
  card only the chip check calls it, to hold the kernel against it.

The two agree bit for bit whatever the tiling, since each cell is the same
update of the same inputs. The dispatch is by the tensors' device and
nothing else, as in `stencil_mwd.run`.
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
                                       check_kernel_inputs, hoist_groups,
                                       op_tables, ptr)

LAUNCHES = trace.counter("k2.launches")

# Hopper (sm_90, the kernels' only target): dynamic shared memory one block
# may opt into, shared memory of one SM, what the runtime reserves per
# block, the threads one SM's 65,536 registers hold at the kernel's 64, the
# CTAs one SM holds at most, and the SMs of an H100 SXM
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024
THREADS_PER_SM = 1_024
CTAS_PER_SM = 32
SMS = 132
MAX_THREADS = 1_024        # threads per CTA (SWEEP_MAX_THREADS)
MAX_AHEAD = 2              # planes loaded ahead (SWEEP_MAX_AHEAD)
MAX_PREFETCH = 16          # planes prefetched into L2 (SWEEP_MAX_PREFETCH)
GEO_LEN = 21               # entries of the launcher's geo (SWEEP_GEO_LEN)
# how cur reaches the taps: a shared-memory ring filled by cp.async, or in
# place through L1/L2 (where no ring fits)
COPIES = ("cp.async", "in-place")
TX_CHOICES = (256, 128, 64, 32)     # x tiles: whole warps of cells
TY_CHOICES = (32, 16, 8, 4, 2, 1)


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How K2 tiles one step, and the shared memory that takes.

    A CTA owns ``ty`` rows by ``tx`` columns of ``chunk`` planes (the last
    tile of each axis clipped to the grid) and walks its planes with
    ``threads`` threads, each updating `cells` cells 32 columns apart (a
    warp covers ``32 * cells`` columns of a row): four (two of 8-byte
    words) where no coefficient load is hoisted, else one. Ring cell (y, x)
    of the CTA whose tile starts at (cy, cx) is grid cell
    ``(cy - my + y, cx - mx + x)``; plane k sits in slot ``k % depth``.
    The dynamic shared memory holds the per-slot tap table (`tab_ints`
    ints) and, from byte `base`, the ring. `prefetch` > 0 has the
    tile's rows of prev and the coefficient streams prefetched into L2 that
    many planes before the step that reads them. The in-place path keeps
    no ring: every ring field is 0.
    """

    ty: int
    tx: int
    threads: int
    chunk: int
    ahead: int
    hoist: int
    copy: str
    mx: int
    my: int
    width: int
    height: int
    depth: int
    base: int
    tab_ints: int
    smem_bytes: int
    cells: int
    prefetch: int

    @property
    def ctas_per_sm(self) -> int:
        """CTAs one SM holds by shared memory, registers and its CTA limit."""
        return min(SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED),
                   THREADS_PER_SM // self.threads, CTAS_PER_SM)

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_PER_BLOCK


def tile_layout(spec: st.StencilSpec, ty: int, tx: int, elem: int, *,
                threads: int, chunk: int, ahead: int = MAX_AHEAD,
                copy: str = "cp.async", prefetch: int = 0) -> TilePlan:
    """The shared-memory layout of one CTA for a (ty, tx) tile.

    The ring holds ``2R + 1 + ahead`` planes of ``ty + 2R`` rows; a row
    starts ``mx`` columns left of the tile, R rounded up to 16 bytes, and is
    ``width`` cells long, rounded up to 16 bytes, so that rows stream in 16
    bytes at a time. An op without prev or coefficient streams prefetches
    nothing; the in-place path hoists no coefficient load (the one instance
    built for it).
    """
    if copy not in COPIES:
        raise ValueError(f"unknown copy path {copy!r}")
    if not 32 <= threads <= MAX_THREADS or threads % 32:
        raise ValueError(f"the sweep kernel takes 32 to {MAX_THREADS} "
                         f"threads in whole warps, got {threads}")
    if not 1 <= ahead <= MAX_AHEAD:
        raise ValueError(f"the sweep kernel loads 1 to {MAX_AHEAD} planes "
                         f"ahead, got {ahead}")
    if not 0 <= prefetch <= MAX_PREFETCH:
        raise ValueError(f"the sweep kernel prefetches 0 to {MAX_PREFETCH} "
                         f"planes, got {prefetch}")
    if ty < 1 or chunk < 1 or tx < 1:
        raise ValueError(f"tile {ty} x {tx} x {chunk}")
    streams = (spec.time_order == 2) + spec.n_coeff_arrays
    prefetch = prefetch if streams else 0
    hoist = 0 if copy == "in-place" else hoist_groups(spec)
    v = 1 if hoist else 2 if elem == 8 else 4
    if tx % (32 * v):
        raise ValueError(f"x tile {tx}: {v} cells a thread, 32 apart, want "
                         f"a whole multiple of {32 * v} columns")
    h = tx // v
    if h > threads or threads % h:
        raise ValueError(f"{threads} threads do not cover whole rows of "
                         f"{h} columns")
    if copy == "in-place":
        return TilePlan(ty, tx, threads, chunk, ahead, hoist, copy,
                        *([0] * 8), v, prefetch)
    r, e, n_taps = spec.radius, 16 // elem, len(spec.taps)
    mx = _up(r, e)
    width, height, depth = _up(mx + tx + r, e), ty + 2 * r, 2 * r + 1 + ahead
    tab_ints = depth * n_taps
    base = _up(4 * tab_ints, 16)
    smem = base + depth * height * width * elem
    return TilePlan(ty, tx, threads, chunk, ahead, hoist, copy, mx, r, width,
                    height, depth, base, tab_ints, smem, v, prefetch)


def n_ctas(shape, plan: TilePlan) -> int:
    nz, ny, nx = shape
    return -(-nz // plan.chunk) * -(-ny // plan.ty) * -(-nx // plan.tx)


# The measured choice at 512^3 x 8 steps, f32, bz = 8 on an H100
# (chip_smoke.py --sweep-k2, PERF.md), per kind of op: without prev or
# coefficient streams (7pt-const), with array-coefficient groups at a radius
# of at most 2 (7pt-var) or more (25pt-var), and with prev or a coefficient
# stream but no array-coefficient group (25pt-const)
TILES = {
    "plain": dict(tx=256, ty=16, threads=512, chunk=64, ahead=2,
                  prefetch=0),
    "hoisted": dict(tx=256, ty=8, threads=256, chunk=16, ahead=1,
                    prefetch=0),
    "hoisted-wide": dict(tx=64, ty=8, threads=256, chunk=64, ahead=1,
                         prefetch=0),
    "streams": dict(tx=128, ty=32, threads=1024, chunk=32, ahead=1,
                    prefetch=2),
}


def measured_tile(spec: st.StencilSpec) -> dict:
    """The plan of `TILES` that `choose_tile` starts from for `spec`."""
    if hoist_groups(spec):
        return TILES["hoisted-wide" if spec.radius > 2 else "hoisted"]
    if spec.time_order == 2 or spec.n_coeff_arrays:
        return TILES["streams"]
    return TILES["plain"]


def choose_tile(spec: st.StencilSpec, shape, bz: int, elem: int) -> TilePlan:
    """K2's own choice of tile, threads, chunk, loads ahead and prefetch.

    The measured plan (`measured_tile`), its tile no wider or taller than
    the grid needs (an x tile the instance's cells cover, else the
    narrowest wider one); a chunk of the most whole multiples of `bz` up to
    its planes (at least one, so a `bz` beyond nz is one chunk), halved
    while the grid holds fewer CTAs than the card does at once (small
    grids; unmeasured). Where the ring does not fit a block, the y tile
    halves, then the x tile, then one plane is loaded ahead; where none
    fits (a radius far beyond the paper's), taps are read in place.
    Refuses nothing.
    """
    if bz < 1:
        raise ValueError(f"bz must be >= 1, got {bz}")
    nz, ny, nx = shape
    t = measured_tile(spec)
    need_x = min([w for w in TX_CHOICES if w >= nx], default=TX_CHOICES[0])
    need_y = min([h for h in TY_CHOICES if h >= ny], default=TY_CHOICES[0])
    narrow = [w for w in TX_CHOICES if w <= min(t["tx"], need_x)]
    widths = narrow + sorted(set(TX_CHOICES) - set(narrow))
    heights = [h for h in TY_CHOICES if h <= min(t["ty"], need_y)]

    def plan(ty, tx, ahead, copy):
        m = max(1, t["chunk"] // bz)
        try:
            p = tile_layout(spec, ty, tx, elem, threads=t["threads"],
                            chunk=bz * m, ahead=ahead, copy=copy,
                            prefetch=t["prefetch"])
        except ValueError:              # cells that do not cover the tile
            return None
        while m > 1 and n_ctas(shape, p) < SMS * p.ctas_per_sm:
            m //= 2
            p = dataclasses.replace(p, chunk=bz * m)
        return p

    for ahead in range(t["ahead"], 0, -1):
        for tx in widths:
            for ty in heights:
                p = plan(ty, tx, ahead, "cp.async")
                if p is not None and p.fits:
                    return p
    return next(p for tx in widths
                for p in [plan(heights[0], tx, 1, "in-place")] if p)


def tile_bytes(spec: st.StencilSpec, shape, plan: TilePlan, elem: int) -> int:
    """HBM bytes of one step if no CTA reuses another's bytes.

    Per CTA: cur over the ring's box (the planes, rows and columns it
    loads, clipped to the grid; the in-place path: the tile widened by R),
    prev (2nd order) and every coefficient stream over the tile, and the
    tile written. An upper estimate of the traffic of the chosen tiling;
    the compulsory bytes are the lower one.
    """
    r = spec.radius
    ring = plan.copy != "in-place"
    lo = (r, plan.my, plan.mx) if ring else (r, r, r)
    ext = (plan.chunk + r, plan.height - plan.my, plan.width - plan.mx) \
        if ring else (plan.chunk + r, plan.ty + r, plan.tx + r)
    tiles = (plan.chunk, plan.ty, plan.tx)
    box = 1
    for n, t, a, b in zip(shape, tiles, lo, ext):
        box *= sum(min(c + b, n) - max(c - a, 0) for c in range(0, n, t))
    cells = shape[0] * shape[1] * shape[2]
    streams = (spec.time_order == 2) + spec.n_coeff_arrays + 1
    return (box + streams * cells) * elem


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
    """The built ``csrc/sweep.cu`` with its launchers' C signatures declared."""
    lib = _build.load("sweep").lib
    lib.sweep_step.restype = ctypes.c_int
    lib.sweep_step.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sweep_config.restype = ctypes.c_int
    lib.sweep_config.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.sweep_error_string.restype = ctypes.c_char_p
    lib.sweep_error_string.argtypes = [ctypes.c_int]
    return lib


def _geometry(spec: st.StencilSpec, shape, plan: TilePlan) -> np.ndarray:
    """The launcher's ``geo`` table (see ``csrc/sweep.cu``). A chunk beyond
    nz is passed as nz: one chunk either way."""
    return np.asarray(
        [*shape, min(plan.chunk, shape[0]), plan.ty, plan.tx, plan.threads,
         spec.radius, plan.ahead, plan.hoist, int(plan.copy == "cp.async"),
         spec.n_coeff_arrays, plan.smem_bytes, plan.tab_ints, plan.mx,
         plan.my, plan.width, plan.height, plan.depth, plan.base,
         plan.prefetch], np.int64)


def _plan(spec: st.StencilSpec, cur, bz: int) -> TilePlan:
    return choose_tile(spec, tuple(cur.shape), bz, cur.element_size())


def _raise(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"sweep kernel {what} failed ({rc}): "
                           f"{lib.sweep_error_string(rc).decode()}")


def kernel_config(spec: st.StencilSpec, cur, *, bz: int = 8) -> dict:
    """The launch configuration of one step over CUDA grid `cur`.

    Keys: ty, tx, threads, chunk (planes a CTA walks), ahead (planes loaded
    early), ring_planes, copy, prefetch (planes of the streams prefetched
    into L2 ahead), hoist and cells (the instance: groups whose coefficient
    loads go first, cells a thread), smem_bytes (dynamic shared memory per
    CTA), ctas (in the grid) and resident (CTAs per SM, by the occupancy
    API).
    """
    dev = check_kernel_inputs("sweep", [cur])
    plan = _plan(spec, cur, bz)
    geo = _geometry(spec, cur.shape, plan)
    lib = _sweep_lib()
    out = np.zeros(1, np.int32)
    _raise(lib, lib.sweep_config(TYPE_CODES[cur.dtype], ptr(geo),
                                 len(spec.taps), dev.index, ptr(out)),
           "configuration")
    return {"ty": plan.ty, "tx": plan.tx, "threads": plan.threads,
            "chunk": plan.chunk, "ahead": plan.ahead,
            "ring_planes": plan.depth, "copy": plan.copy,
            "prefetch": plan.prefetch, "hoist": plan.hoist, "cells": plan.cells,
            "smem_bytes": plan.smem_bytes,
            "ctas": n_ctas(tuple(cur.shape), plan),
            "resident": int(out[0])}


def run_kernel(spec: st.StencilSpec, state, arrays, scalars, *, bz: int = 8):
    """One step on the CUDA kernel: ``(new, cur)``, `new` freshly allocated."""
    cur, prev = state
    dev = check_kernel_inputs(
        "sweep", [cur, prev] + ([arrays] if arrays is not None else []))
    nz, ny, nx = cur.shape
    taps, groups, values = op_tables(spec, scalars, ny * nx, nx)
    taps3 = np.asarray([t.offset for _, members in spec.groups
                        for t in members], np.int32)
    geo = _geometry(spec, cur.shape, _plan(spec, cur, bz))
    new = torch.empty_like(cur)
    lib = _sweep_lib()
    rc = lib.sweep_step(
        TYPE_CODES[cur.dtype], new.data_ptr(), cur.data_ptr(),
        prev.data_ptr(), arrays.data_ptr() if arrays is not None else None,
        ptr(geo), ptr(taps), ptr(taps3), len(taps), ptr(groups),
        ptr(values), len(spec.groups), spec.time_order, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise(lib, rc, "launch")
    LAUNCHES.count += 1
    return new, cur


def sweep_step(spec: st.StencilSpec, state, arrays, scalars, *, bz: int = 8):
    """One interior-update time step: state -> ``(new, cur)``.

    `arrays` is the op's stacked ``(A, z, y, x)`` coefficient stream (or
    None) and `scalars` its scalar tuple; `bz` is the reference's z-slab,
    of which the kernel's z chunk is a whole multiple.
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
