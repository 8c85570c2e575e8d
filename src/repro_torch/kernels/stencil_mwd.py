"""K1: the MWD advance, as a hand-written CUDA kernel plus its plain version.

The port of `repro.kernels.stencil_mwd`. The host side is the reference's
`_mwd_run_impl`, carried over exactly: `sync_dirichlet_frame` on prev, the
``2R | d_w`` and ``n_f | d_w`` checks, edge padding of the two parity
grids by ``pz = R``, ``py = 2*D_w + R``, ``px = R`` with z padded up to
``n_j * N_F`` (and x on the right up to a multiple of 16 bytes, columns
nothing reads), the compiled schedule tables, the ``n_steps = 0`` identity,
and the crop and parity pick at the end. The coefficient streams are not
padded: they are read only at updated cells, which are interior, so the
kernel addresses them at the unpadded offset and `prepare` hands them over
as they are.

Two executors consume the padded parity grids and the tables:

* `run_kernel` launches ``csrc/mwd.cu``: one launch per diamond row, one
  thread-block cluster per tile and batch entry, its CTAs splitting x into
  slabs, each CTA with a shared-memory z-ring of both parity windows (and
  of the coefficient streams where they fit), x-halos exchanged through
  distributed shared memory with a cluster barrier after each update whose
  halo a later update reads (at dw8 none does at the 25-point ops, whose
  CTAs then run without a cluster). The kernel picks the slab width,
  cluster size, staging and block size (`kernel_config` reports them);
  ``prepare(cluster=c)`` asks for c CTAs a tile instead, the paper's
  thread-group size, which the kernel takes or refuses (`LaunchRefused`),
  never swapping in another. An op of one of the star layouts K1 compiles
  in (`_host.star_layout`: the paper's operators, their masked twins and
  the 7-point adjoints) runs that layout's instance in f32 and f64, whose
  taps are compile-time offsets; any other op, dtype or accumulator runs
  the generic instance, with the same bits and the same launch plan. It
  takes CUDA tensors only and raises on anything else.
* `run_plain` walks the same tables tile by tile in row-major order with
  torch slicing, each span over the whole z extent, on its own padded copy
  of the coefficients. The CPU path uses it; on the card only the chip
  check calls it, to hold the kernel against it.

The dispatch is by the tensors' device and nothing else: CUDA tensors go to
the kernel or the call raises, CPU tensors go to the plain version.

Modes: ``fused=True`` runs every row on one pair of padded grids and skips
the tiles that own no span; ``fused=False`` copies both grids before each
row and runs every tile (the reference's per-row pass). Both come out
bitwise equal. A leading batch axis runs B independent grids in the same
launches, bitwise equal to a per-item loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import ir, tiling, trace
from repro_torch.core import stencils as st
from repro_torch.core.mwd import (K1Geometry, barrier_schedule,
                                   k1_geometry, sync_dirichlet_frame)
from repro_torch.kernels import _build
from repro_torch.kernels._host import (TYPE_CODES, check_inputs,
                                         check_kernel_inputs, edge_pad,
                                         op_tables, ptr, star_layout)


LAUNCHES = trace.counter("k1.launches")
STAR_LAUNCHES = trace.counter("k1.star_launches")   # of a star instance
SYNCS = trace.counter("syncs")      # host waits on the device

MAX_CLUSTER = 16        # MWD_MAX_CLUSTER of csrc/mwd.cu

# launcher codes for a configuration the kernel does not take (csrc/mwd.cu):
# no resident cluster, no rings that fit, a cluster size the slab rounding
# does not reach
REFUSALS = {-4: "E_CLUSTER", -5: "E_SMEM", -6: "E_CLUSTER_SIZE"}


class LaunchRefused(RuntimeError):
    """K1 does not take the job's configuration (`REFUSALS`); `code`
    names the launcher's error."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{message} [{code}]")
        self.code = code


@dataclasses.dataclass
class Job:
    """One MWD advance, prepared for an executor.

    `bufs` are the padded parity grids ``([B,] nz_tot, nyp, nxp)`` (even,
    odd) and `coeff` the caller's stacked streams ``([B,] A, nz, ny, nx)``,
    unpadded and uncopied; both executors update `bufs` in place (per-row
    mode swaps in fresh copies per row). `bufs` is None when the schedule
    is empty (``n_steps == 0``); `cur`/`prev` then are the result.
    """

    op: ir.StencilOp
    cur: torch.Tensor
    prev: torch.Tensor               # frame-synced
    n_steps: int
    bufs: list | None = None
    coeff: torch.Tensor | None = None
    scalars: tuple[float, ...] = ()
    comp: tiling.CompiledSchedule | None = None
    bounds: tuple[int, ...] = ()     # padded interior lo_z, hi_z, lo_y, ...
    pads: tuple[int, int, int] = (0, 0, 0)
    n_f: int = 1
    n_j: int = 0
    fused: bool = True
    acc_dtype: torch.dtype | None = None
    cluster: int | None = None       # CTAs a tile asked for; None: kernel's


def prepare(spec: st.StencilSpec, state, arrays, scalars, n_steps: int, *,
            d_w: int, n_f: int, fused: bool, interior=None, y_domain=None,
            acc_dtype=None, cluster: int | None = None) -> Job:
    """Checks, frame sync, padding and schedule tables of one advance.

    `state` is ``(cur, prev)`` with optional leading batch axis, `arrays`
    the stacked coefficient streams (or None, leading batch axis when
    batched), `scalars` the op's scalar tuple. `interior` is
    ``[lo_z, hi_z, lo_y, hi_y, lo_x, hi_x]`` in grid coordinates (default:
    the R-deep Dirichlet frame); `y_domain` the tessellation's y extent
    (default ``(R, ny - R)``). `cluster` asks the kernel for that many
    CTAs a tile (1 to `MAX_CLUSTER`; None lets it choose); the plain
    version's result does not depend on it.
    """
    with trace.span("girih.mwd.prepare"):
        if cluster is not None and not 1 <= cluster <= MAX_CLUSTER:
            raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, got "
                             f"{cluster}")
        cur, prev = state
        if acc_dtype is not None and acc_dtype == cur.dtype:
            acc_dtype = None            # native accumulation: no casts
        nz, ny, nx = cur.shape[-3:]
        geo = k1_geometry(spec.radius, (nz, ny, nx), d_w, n_f, n_steps,
                          fused=fused, interior=interior, y_domain=y_domain)
        check_inputs(spec, cur, prev, arrays)
        prev = sync_dirichlet_frame(cur, prev, spec.radius)
        job = Job(op=spec, cur=cur, prev=prev, n_steps=n_steps)
        if geo.comp.n_rows == 0:         # n_steps == 0: nothing to launch
            return job
        pz, py, px = geo.pads
        # x rows a multiple of 16 bytes, so the kernel streams them 16
        # bytes at a time; the extra right-hand columns are never read
        x_hi = px + (-(nx + 2 * px)) % (16 // cur.element_size())
        pads = ((pz, geo.n_j * n_f - nz - pz), (py, py), (px, x_hi))
        job.bufs = [edge_pad(cur, pads), edge_pad(prev, pads)]
        job.coeff = arrays.contiguous() if spec.n_coeff_arrays else None
        job.scalars = tuple(float(x) for x in scalars)
        job.comp, job.bounds, job.pads = geo.comp, geo.bounds, geo.pads
        job.n_f, job.n_j, job.fused = n_f, geo.n_j, fused
        job.acc_dtype, job.cluster = acc_dtype, cluster
        return job


def finish(job: Job) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop the padded grids and pick the parities: ``(cur, prev)``."""
    if job.bufs is None:
        return job.cur, job.prev
    with trace.span("girih.mwd.finish"):
        pz, py, px = job.pads
        nz, ny, nx = job.cur.shape[-3:]
        core = (..., slice(pz, pz + nz), slice(py, py + ny),
                slice(px, px + nx))
        p = job.n_steps % 2
        return (job.bufs[p][core].contiguous(),
                job.bufs[1 - p][core].contiguous())


def run_plain(job: Job) -> None:
    """The plain PyTorch version of the kernel: same tables, row-major tiles."""
    comp, op = job.comp, job.op
    lo_z, hi_z, lo_y, hi_y, lo_x, hi_x = job.bounds
    pz, py, px = job.pads
    coeff = None
    if job.coeff is not None:
        nz, ny, nx = job.coeff.shape[-3:]
        nz_tot, nyp, nxp = job.bufs[0].shape[-3:]
        coeff = edge_pad(job.coeff, ((pz, nz_tot - nz - pz),
                                     (py, nyp - ny - py),
                                     (px, nxp - nx - px)))
    for i in range(comp.n_rows):
        if not job.fused:
            job.bufs = [b.clone() for b in job.bufs]
        p0 = int(comp.parity[i])
        for k in range(comp.n_tiles):
            if job.fused and not comp.active[i, k]:
                continue
            for tau in range(comp.t_steps):
                ya = max(int(comp.y0[i, k, tau]) + py, lo_y)
                yb = min(int(comp.y1[i, k, tau]) + py, hi_y)
                if yb <= ya or hi_z <= lo_z or hi_x <= lo_x:
                    continue
                p = (p0 + tau) % 2
                src, dst = job.bufs[p], job.bufs[1 - p]
                dst[..., lo_z:hi_z, ya:yb, lo_x:hi_x] = ir.sweep_region(
                    op, src, dst, coeff, job.scalars, (lo_z, ya, lo_x),
                    (hi_z, yb, hi_x), job.acc_dtype)


@functools.lru_cache(maxsize=None)
def _mwd_lib() -> ctypes.CDLL:
    """The built ``csrc/mwd.cu`` with its launchers' C signatures declared."""
    lib = _build.load("mwd").lib
    lib.mwd_rows.restype = ctypes.c_int
    lib.mwd_rows.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mwd_config.restype = ctypes.c_int
    lib.mwd_config.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p]
                               + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.mwd_error_string.restype = ctypes.c_char_p
    lib.mwd_error_string.argtypes = [ctypes.c_int]
    return lib


def halo_schedule(job: Job) -> tuple[np.ndarray, np.ndarray]:
    """Which updates of a prepared job push x-halos, and the cluster
    barriers they cost (`core.mwd.barrier_schedule`)."""
    return barrier_schedule(K1Geometry(
        comp=job.comp, pads=job.pads, bounds=job.bounds, n_f=job.n_f,
        n_j=job.n_j, radius=job.op.radius, fused=job.fused))


def _geometry(job: Job) -> np.ndarray:
    """The launcher's ``geo`` table of a job (see ``csrc/mwd.cu``)."""
    comp, op = job.comp, job.op
    nz_tot, nyp, nxp = job.bufs[0].shape[-3:]
    nz, ny, nx = job.cur.shape[-3:]
    return np.asarray([
        nz_tot * nyp * nxp, nyp * nxp, nxp, op.n_coeff_arrays, job.n_j,
        job.n_f, op.radius, comp.t_steps, comp.n_tiles, *job.bounds,
        int(job.fused), nz, ny, nx, *job.pads, comp.d_w, len(op.taps),
        sum(coeff.kind == "array" for coeff, _ in op.groups),
        job.cluster or 0, int(halo_schedule(job)[0].any())], np.int64)


def _check(lib, rc: int, what: str) -> None:
    if rc == 0:
        return
    message = (f"MWD kernel {what} failed ({rc}): "
               f"{lib.mwd_error_string(rc).decode()}")
    if rc in REFUSALS:
        raise LaunchRefused(REFUSALS[rc], message)
    raise RuntimeError(message)


def _type_codes(job: Job) -> tuple[int, int]:
    dt = job.bufs[0].dtype
    acc = job.acc_dtype if job.acc_dtype is not None else dt
    if dt not in TYPE_CODES or acc not in TYPE_CODES:
        raise ValueError(f"the MWD kernel has no {dt}/{acc} variant")
    return TYPE_CODES[dt], TYPE_CODES[acc]


def star_code(job: Job) -> int:
    """The star layout K1 runs a prepared job's op in (`_host.star_layout`),
    or 0 for the generic instance: star instances are built for f32 and f64
    streams in their own precision."""
    native = job.acc_dtype is None or job.acc_dtype == job.bufs[0].dtype
    if not native or job.bufs[0].dtype not in (torch.float32, torch.float64):
        return 0
    return star_layout(job.op)


def kernel_config(job: Job) -> dict:
    """The launch configuration the kernel picks for a prepared CUDA job.

    Keys: cluster (CTAs per tile), slab (x columns per CTA), stage
    (coefficients staged in shared memory), threads, smem_bytes (dynamic
    shared memory per CTA), max_active_clusters, depth and cdepth (ring
    depths in z rows), hoist (coefficient groups whose loads the generic
    instance issues together; a star instance, `star_code`, issues every
    group's), exchange (1: the CTAs of a tile run as a cluster and trade
    halos; 0: no update needs a neighbour's halo, so they run alone),
    static_smem (the chosen instance's static shared memory, which the
    opt-in limit holds beside `smem_bytes`). Raises `LaunchRefused` where
    the kernel does not take the job (at a requested `cluster`: that size).
    """
    dev = check_kernel_inputs("MWD", job.bufs)
    lib = _mwd_lib()
    out = np.zeros(11, np.int32)
    _check(lib, lib.mwd_config(*_type_codes(job), ptr(_geometry(job)),
                               star_code(job), dev.index, ptr(out)),
           "configuration")
    keys = ("cluster", "slab", "stage", "threads", "smem_bytes",
            "max_active_clusters", "depth", "cdepth", "hoist", "exchange",
            "static_smem")
    return dict(zip(keys, (int(v) for v in out)))


def run_kernel(job: Job) -> None:
    """Launch the CUDA kernel on the job's CUDA tensors, one launch per row."""
    streams = job.bufs + ([job.coeff] if job.coeff is not None else [])
    dev = check_kernel_inputs("MWD", streams)
    codes, star = _type_codes(job), star_code(job)
    comp, op = job.comp, job.op
    nz_tot, nyp, nxp = job.bufs[0].shape[-3:]
    batch = job.bufs[0].numel() // (nz_tot * nyp * nxp)
    with trace.span("girih.mwd.tables"):
        taps, groups, values = op_tables(op, job.scalars, nyp * nxp, nxp)
        taps3 = np.asarray([t.offset for _, members in op.groups
                            for t in members], np.int32)
        py = job.pads[1]
        tables = np.concatenate([
            comp.parity, (comp.w0 + py).ravel(), comp.active.ravel(),
            (comp.y0 + py).ravel(), (comp.y1 + py).ravel()]).astype(np.int32)
    lib = _mwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(row_begin: int, row_end: int) -> None:
        check_kernel_inputs(
            "MWD", job.bufs + ([job.coeff] if job.coeff is not None else []))
        rc = lib.mwd_rows(
            *codes, job.bufs[0].data_ptr(), job.bufs[1].data_ptr(),
            job.coeff.data_ptr() if job.coeff is not None else None,
            ptr(geo), ptr(taps), ptr(taps3), len(taps), ptr(groups),
            ptr(values), len(op.groups), op.time_order, star,
            tables.data_ptr(), comp.n_rows, row_begin, row_end, batch,
            dev.index, stream)
        _check(lib, rc, "launch")
        LAUNCHES.count += row_end - row_begin
        if star:
            STAR_LAUNCHES.count += row_end - row_begin

    # the span opens before the upload, so no profiler event of the program
    # lands in the drain that follows it
    with trace.span("girih.mwd.launch"):
        # a pageable upload: the host waits for the stream to drain
        with SYNCS.timed("girih.sync"):
            tables = torch.from_numpy(tables).to(dev)
        geo = _geometry(job)
        if job.fused:
            launch(0, comp.n_rows)
        else:
            for i in range(comp.n_rows):
                job.bufs = [b.clone() for b in job.bufs]
                launch(i, i + 1)


def run(job: Job) -> tuple[torch.Tensor, torch.Tensor]:
    """Execute a prepared job on its tensors' device and crop the result."""
    if job.bufs is not None:
        if job.bufs[0].is_cuda:
            run_kernel(job)
        else:
            run_plain(job)
    return finish(job)


def mwd_run(spec: st.StencilSpec, state, arrays, scalars, n_steps: int, *,
            d_w: int = 8, n_f: int = 2, fused: bool = True,
            interior=None, y_domain: tuple[int, int] | None = None,
            acc_dtype=None):
    """Advance n_steps with the MWD schedule: state -> state.

    `arrays` is the op's stacked ``(A, z, y, x)`` coefficient stream (or
    None) and `scalars` its scalar tuple. `interior` (grid coordinates) and
    `y_domain` are runtime values, as the distributed stepper needs them.
    `acc_dtype` optionally decouples the accumulator from the stream dtype.
    """
    return run(prepare(spec, state, arrays, scalars, n_steps, d_w=d_w,
                       n_f=n_f, fused=fused, interior=interior,
                       y_domain=y_domain, acc_dtype=acc_dtype))


def mwd_run_batched(spec: st.StencilSpec, state, arrays, scalars,
                    n_steps: int, *, d_w: int = 8, n_f: int = 2,
                    fused: bool = True, acc_dtype=None):
    """Advance B independent same-shaped grids together: state -> state.

    `state` is ``(cur, prev)`` of shape ``(B, nz, ny, nx)`` and `arrays`
    ``(B, A, nz, ny, nx)`` (or None); one scalar tuple is shared by every
    entry. Each launch runs every entry (thread blocks along the batch),
    bitwise equal to a per-item `mwd_run` loop.
    """
    cur = state[0]
    if cur.ndim != 4:
        raise ValueError(f"mwd_run_batched wants (B, nz, ny, nx) states, "
                         f"got shape {tuple(cur.shape)}")
    return run(prepare(spec, state, arrays, scalars, n_steps, d_w=d_w,
                       n_f=n_f, fused=fused, acc_dtype=acc_dtype))
