"""Distributed MWD time-stepper: the paper's MPI layer.

The port of `repro.distributed.stepper`. Domain decomposition (paper Sec.
4.2): z over the data axes ('pod', 'data' flattened), y over 'model', x
never sharded. On one controller (a mesh of `torch.device`s, the default)
one process holds every shard as a tensor on its mesh device
(`launch.mesh`); `GridSharding.shard` and `gather` take the place of the
reference's `device_put` with a `NamedSharding`, and a super-step loops
over the shards where the reference's `shard_map` traces one.

Across processes (a mesh of `ProcessDevice`s under a process group,
`distributed.process`), the reference's multi-controller `shard_map`:
every rank walks the same global grid, holds only its own shards (another
rank's is a `halo.Remote` placeholder), advances only those, and trades
halo slabs with the other ranks through a `halo.Carrier`. `run_distributed`
takes the global problem on every rank and returns the global result on
every rank (`GridSharding.gather` broadcasts each shard from its owner);
``plan="auto"`` resolves on rank 0 and is broadcast.

Each super-step exchanges deep halos of depth g = R * t_block (one
neighbour exchange amortized over t_block local steps), then advances
t_block local steps. Two schedules:

  synchronous (overlap=False): exchange, then advance the whole extended
  block.

  overlapped (overlap=True): each shard splits into an INTERIOR zone whose
  advance reads only pre-exchange local data and BOUNDARY zones of depth g
  per sharded axis that complete from the landed halos. On CUDA the halo
  copies run on a communication stream (`halo.Wire`) while the interior
  runs on the compute stream; the boundary launches wait for the copies.
  Across processes the exchange's first phase is staged before the
  interior launches and traded after them (`_Exchange.land`).

Two local executors:

  plan=None: the generated plain sweep (`ir.make_sweep`), the reference's
  portable executor. Chosen only by passing plan=None.

  plan=MWDPlan or "auto": one K1 advance (`kernels.stencil_mwd.mwd_run`,
  ``csrc/mwd.cu`` on the card) per shard per super-step, or per zone in
  the overlapped schedule, on the halo-extended block with the global
  Dirichlet frame clipped into it as K1's runtime `interior`.

Every schedule is bitwise equal to every other and to `ops.naive` on the
global grid in exact arithmetic; the exchange copies values unchanged, so
the port holds them bitwise (the compressed exchange excepted).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import ir
from repro_torch.core import stencils as st
from repro_torch.core.mwd import MWDPlan
from repro_torch.distributed import halo, process
from repro_torch.distributed.process import ProcessDevice
from repro_torch.kernels import stencil_mwd
from repro_torch.kernels._host import edge_pad
from repro_torch.models.params import TensorSpec


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """How the (z, y, x) stencil grid maps onto a mesh: z->data axes,
    y->model. A `ProcessDevice` entry is owned by its process; a
    `torch.device` by this one."""

    mesh: object

    def __post_init__(self):
        owners = {e.process_index for e in self._process_entries()}
        if owners and max(owners) >= process.process_count():
            raise ValueError(
                f"the mesh spans processes {sorted(owners)} but the "
                f"process group has {process.process_count()}: start one "
                f"rank per process (repro_torch.distributed.process."
                f"initialize)")

    @property
    def z_axes(self) -> tuple[str, ...]:
        """Mesh axes the grid's z dimension is sharded over (flattened)."""
        return tuple(a for a in ("pod", "data") if a in self.mesh.axis_names)

    @property
    def y_axis(self) -> str:
        """Mesh axis the grid's y dimension is sharded over."""
        return "model"

    def _process_entries(self) -> list[ProcessDevice]:
        # a stand-in mesh of axis names and sizes has no devices
        devices = getattr(self.mesh, "devices", None)
        return [e for e in (() if devices is None else devices.flat)
                if isinstance(e, ProcessDevice)]

    @property
    def multiprocess(self) -> bool:
        """True when the mesh's shards live in several processes."""
        return process.process_count() > 1 and bool(self._process_entries())

    def counts(self) -> tuple[int, int]:
        """(n_z, n_y): shard counts along the grid's z and y dimensions."""
        n_z = 1
        for a in self.z_axes:
            n_z *= self.mesh.shape[a]
        return n_z, self.mesh.shape[self.y_axis]

    def entries(self) -> list[list]:
        """The ``[iz][iy]`` grid of mesh entries (z index pod-major over
        the data axes, as the reference's flattened axis index)."""
        names = self.mesh.axis_names
        order = [names.index(a) for a in self.z_axes + (self.y_axis,)]
        rest = [i for i in range(len(names)) if i not in order]
        if any(self.mesh.devices.shape[i] != 1 for i in rest):
            raise ValueError(f"mesh axes {[names[i] for i in rest]} shard "
                             "no grid dimension and must have size 1")
        n_z, n_y = self.counts()
        grid = self.mesh.devices.transpose(order + rest).reshape(n_z, n_y)
        return [list(row) for row in grid]

    def devices(self) -> list[list[torch.device]]:
        """The ``[iz][iy]`` device grid (each entry's device in its own
        process)."""
        return [[e.device if isinstance(e, ProcessDevice) else e
                 for e in row] for row in self.entries()]

    def owners(self) -> list[list[int]]:
        """The ``[iz][iy]`` grid of owning ranks."""
        me = process.process_index()
        return [[e.process_index if isinstance(e, ProcessDevice) else me
                 for e in row] for row in self.entries()]

    def cells(self):
        """Every ``(iz, iy)`` shard index, z-major."""
        n_z, n_y = self.counts()
        return [(iz, iy) for iz in range(n_z) for iy in range(n_y)]

    def local_cells(self):
        """The ``(iz, iy)`` shards this process holds, z-major."""
        me, owners = process.process_index(), self.owners()
        return [(iz, iy) for iz, iy in self.cells() if owners[iz][iy] == me]

    def shard(self, x: torch.Tensor) -> list[list]:
        """Split a global ``(..., z, y, x)`` tensor into the ``[iz][iy]``
        grid of shards: this process's on their mesh devices, another
        rank's as `halo.Remote` placeholders."""
        n_z, n_y = self.counts()
        nz, ny = x.shape[-3], x.shape[-2]
        nz_l, ny_l = nz // n_z, ny // n_y
        devs, owners = self.devices(), self.owners()
        me = process.process_index()

        def block(iz, iy):
            sl = x[..., iz * nz_l:(iz + 1) * nz_l,
                   iy * ny_l:(iy + 1) * ny_l, :]
            if owners[iz][iy] != me:
                return halo.Remote.like(owners[iz][iy], sl.shape, x.dtype)
            return sl.to(devs[iz][iy]).contiguous()

        return [[block(iz, iy) for iy in range(n_y)] for iz in range(n_z)]

    def gather(self, grid, device=None) -> torch.Tensor:
        """The global tensor of a shard grid, on `device` (default: the
        first mesh device, or across processes this rank's first one).
        Across processes every rank gets it: each shard is broadcast from
        its owner, in grid order (through pinned host memory under
        gloo)."""
        if not self.multiprocess:
            dev = device if device is not None else self.devices()[0][0]
            rows = [torch.cat([b.to(dev) for b in row], dim=-2)
                    for row in grid]
            return torch.cat(rows, dim=-3)
        mine = self.local_cells()
        devs, owners = self.devices(), self.owners()
        dev = torch.device(device if device is not None else
                           devs[mine[0][0]][mine[0][1]] if mine else "cpu")
        host = process.backend() == "gloo"
        pin = host and dev.type == "cuda"
        first = grid[0][0]
        lead = tuple(first.shape[:-3])
        nz = sum(row[0].shape[-3] for row in grid)
        ny = sum(b.shape[-2] for b in grid[0])
        out = torch.empty(lead + (nz, ny, first.shape[-1]),
                          dtype=first.dtype, device=dev)
        z0 = 0
        for iz, row in enumerate(grid):
            y0 = 0
            for iy, b in enumerate(row):
                zs = slice(z0, z0 + b.shape[-3])
                ys = slice(y0, y0 + b.shape[-2])
                y0 += b.shape[-2]
                if halo.is_remote(b) or host:
                    buf = torch.empty(tuple(b.shape), dtype=b.dtype,
                                      device="cpu" if host else dev,
                                      pin_memory=pin)
                if not halo.is_remote(b):
                    if host:
                        buf.copy_(b)
                    else:
                        buf = b.contiguous()
                dist.broadcast(buf, src=owners[iz][iy])
                out[..., zs, ys, :] = buf
            z0 += row[0].shape[-3]
        return out


def _grid(gs: GridSharding, fn):
    """``[iz][iy]`` grid of ``fn(iz, iy)``."""
    n_z, n_y = gs.counts()
    return [[fn(iz, iy) for iy in range(n_y)] for iz in range(n_z)]


def _outputs(grid):
    """An output grid shaped as `grid`: another rank's shards keep their
    placeholders, this process's are filled in by the caller."""
    return [[b if halo.is_remote(b) else None for b in row] for row in grid]


def _each(grid, fn):
    """`fn` on every block of a grid; a placeholder gets the shape of the
    result (`halo.Remote.apply`)."""
    return [[b.apply(fn) if halo.is_remote(b) else fn(b) for b in row]
            for row in grid]


# ---------------------------------------------------------------------------
# interior/boundary partition geometry (pure, static)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Zone:
    """One boundary zone of the overlapped super-step.

    `z`/`y` slice the halo-EXTENDED local block (extent + 2g on both axes);
    `kept` is the box of cells this zone contributes to the assembled output,
    in slab coordinates; `origin` is the LOCAL-grid coordinate of slab cell
    (0, 0) (add the shard's global offset for the Dirichlet-frame mask).
    """

    name: str
    z: slice
    y: slice
    kept: tuple[tuple[int, int], tuple[int, int]]
    origin: tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Interior/boundary split of one local block for the overlapped step.

    The interior pass runs on the raw local block, padded by g only on axes
    that do NOT cross a shard boundary (x always; z/y when unsharded).
    `interior_kept` / `interior_origin` follow `Zone.kept` / `Zone.origin`
    in interior-block coordinates. Boundary `zones` exist only for sharded
    axes.
    """

    local_shape: tuple[int, int, int]
    g: int
    split_z: bool
    split_y: bool
    interior_kept: tuple[tuple[int, int], tuple[int, int]]
    interior_origin: tuple[int, int]
    zones: tuple[Zone, ...]


def partition_geometry(local_shape, g: int, split_z: bool,
                       split_y: bool) -> Partition:
    """Compute the interior/boundary split of one shard's local block.

    Sharded ("split") axes contribute two boundary zones of depth g each
    (slabs 3g thick: the kept g cells plus the g-deep support on either
    side); corners belong to the z zones, so the y zones keep only the z
    range the interior also keeps. Unsharded axes need no zones.
    """
    nz_l, ny_l, _ = local_shape
    nz_e, ny_e = nz_l + 2 * g, ny_l + 2 * g
    kz = (g, nz_l - g) if split_z else (0, nz_l)
    ky = (g, ny_l - g) if split_y else (0, ny_l)
    zones = []
    if split_z:
        zones.append(Zone("z_lo", slice(0, 3 * g), slice(0, ny_e),
                          ((g, 2 * g), (g, g + ny_l)), (-g, -g)))
        zones.append(Zone("z_hi", slice(nz_e - 3 * g, nz_e), slice(0, ny_e),
                          ((g, 2 * g), (g, g + ny_l)), (nz_l - 2 * g, -g)))
    if split_y:
        zsl = slice(g, g + nz_l) if split_z else slice(0, nz_e)
        zo = 0 if split_z else -g
        zk = ((g, nz_l - g) if split_z else (g, g + nz_l))
        zones.append(Zone("y_lo", zsl, slice(0, 3 * g),
                          (zk, (g, 2 * g)), (zo, -g)))
        zones.append(Zone("y_hi", zsl, slice(ny_e - 3 * g, ny_e),
                          (zk, (g, 2 * g)), (zo, ny_l - 2 * g)))
    ikz = kz if split_z else (g, g + nz_l)
    iky = ky if split_y else (g, g + ny_l)
    return Partition(tuple(local_shape), g, split_z, split_y,
                     (ikz, iky), (0 if split_z else -g, 0 if split_y else -g),
                     tuple(zones))


def overlap_work(local_shape, r: int, t_block: int, split_z: bool = True,
                 split_y: bool = True) -> dict:
    """Exact swept-cell counts per super-step: synchronous vs overlapped.

    The interior trapezoid over a kept box of extents (KZ, KY) computes
    (KZ + 2m)(KY + 2m)(nx + 2g - 2r) cells at sub-step t, m = r*(t_block-t);
    each boundary zone sweeps its full 3g-thick slab every sub-step, the
    synchronous path the full extended block's interior. These counts feed
    `models.super_step_time`.
    """
    nz_l, ny_l, nx_l = local_shape
    g = r * t_block
    x = nx_l + 2 * g - 2 * r
    sync = t_block * (nz_l + 2 * g - 2 * r) * (ny_l + 2 * g - 2 * r) * x

    def trap(kz, ky):
        return sum((kz + 2 * r * (t_block - t)) * (ky + 2 * r * (t_block - t))
                   for t in range(1, t_block + 1)) * x

    ikz = nz_l - 2 * g if split_z else nz_l
    iky = ny_l - 2 * g if split_y else ny_l
    interior = trap(ikz, iky)
    boundary = 0
    if split_z:
        boundary += 2 * t_block * (3 * g - 2 * r) * (ny_l + 2 * g - 2 * r) * x
    if split_y:
        yz = nz_l if split_z else nz_l + 2 * g
        boundary += 2 * t_block * (yz - 2 * r) * (3 * g - 2 * r) * x
    return {"sync_cells": sync, "interior_cells": interior,
            "boundary_cells": boundary}


def validate_super_step(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                        *, overlap: bool = False) -> None:
    """Check the decomposition geometry before running anything.

    Raises ValueError when the grid does not decompose evenly, when the
    deep-halo depth g = R * t_block exceeds a local shard extent, or, with
    overlap=True, when the boundary zones would leave no halo-independent
    interior. The reference's messages.
    """
    gs = GridSharding(mesh)
    n_z, n_y = gs.counts()
    nz, ny, _ = grid_shape
    if nz % n_z or ny % n_y:
        raise ValueError(
            f"grid {tuple(grid_shape)} does not decompose evenly over mesh "
            f"{dict(mesh.shape)}: z extent {nz} must divide by the {n_z} "
            f"z-shards and y extent {ny} by the {n_y} y-shards; pad the grid "
            f"or choose a mesh whose ('pod','data') x 'model' factors divide "
            f"(z, y)")
    r = spec.radius
    g = r * t_block
    nz_l, ny_l = nz // n_z, ny // n_y
    if g > nz_l or g > ny_l:
        raise ValueError(
            f"halo depth g = R*t_block = {r}*{t_block} = {g} exceeds the "
            f"local shard extent (nz_l={nz_l}, ny_l={ny_l}): the single-hop "
            f"deep-halo exchange can only source a neighbor's own cells. "
            f"Lower t_block to <= {min(nz_l, ny_l) // r} or use a coarser "
            f"decomposition.")
    if overlap:
        lims = ([nz_l] if n_z > 1 else []) + ([ny_l] if n_y > 1 else [])
        small = min(lims, default=None)
        if small is not None and small <= 2 * g:
            raise ValueError(
                f"interior/boundary overlap needs local shard extents "
                f"> 2g = {2 * g} on every sharded axis (got nz_l={nz_l}, "
                f"ny_l={ny_l}): boundary zones of depth g={g} would leave no "
                f"halo-independent interior. Use overlap=False or 'auto', "
                f"lower t_block to <= {max((small - 1) // (2 * r), 1)}, or "
                f"shard the grid more coarsely.")


def overlap_feasible(spec: st.StencilSpec, mesh, grid_shape,
                     t_block: int) -> bool:
    """True when the overlapped schedule is geometrically valid here."""
    try:
        validate_super_step(spec, mesh, grid_shape, t_block, overlap=True)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# coefficients: exchanged once per run (hoisted)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Hoisted:
    """Coefficients extended once at depth `pad_g` (`make_coeff_extender`).

    `arrays` is the ``[iz][iy]`` grid of x-padded, halo-extended stacked
    streams (None for scalar-only ops) and `scalars` the op's scalar tuple.
    `block` crops them to a super-step's depth and a zone's slab; the
    crops are time-invariant, so each is made contiguous once and kept.
    """

    arrays: list | None
    scalars: tuple[float, ...]
    pad_g: int
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def block(self, iz: int, iy: int, g: int, zsl=slice(None),
              ysl=slice(None)):
        """Shard (iz, iy)'s streams at depth g, sliced to (zsl, ysl)."""
        if self.arrays is None:
            return None
        key = (iz, iy, g, zsl.start, zsl.stop, ysl.start, ysl.stop)
        hit = self._cache.get(key)
        if hit is None:
            a = _crop_hoisted(self.arrays[iz][iy], self.pad_g, g)
            hit = a[:, zsl, ysl, :].contiguous()
            self._cache[key] = hit
        return hit


def _padx(a, g: int):
    """Edge-pad the trailing x axis by g (x is never sharded)."""
    return edge_pad(a, ((0, 0), (0, 0), (g, g)))


def _crop_hoisted(arrays_e, pad_g: int, g: int):
    """Crop pre-extended coefficients from their hoisted depth down to g,
    so a partial final super-step reuses them instead of re-exchanging."""
    d = pad_g - g
    if d == 0:
        return arrays_e
    sl = slice(d, -d)
    return arrays_e[:, sl, sl, sl]


def make_coeff_extender(spec: st.StencilSpec, t_block: int):
    """The one coefficient exchange of a run: ``(arrays grid or None,
    scalars) -> Hoisted``, the stacked streams halo-extended by g = R *
    t_block and x-padded, which every super-step of the run reads."""
    g = spec.radius * t_block

    def extend(coeffs) -> Hoisted:
        arrays, scalars = coeffs
        if arrays is None:
            return Hoisted(None, tuple(scalars), g)
        ext = halo.exchange_2d(arrays, g)
        return Hoisted(_each(ext, lambda b: _padx(b, g)), tuple(scalars), g)

    return extend


def canonical_coeffs(spec: st.StencilSpec, coeffs):
    """Packed coefficients -> ``(stacked arrays or None, scalar tuple)``:
    one form for every operator (the reference's stacked-arrays / scalar
    vector pair; K1 takes the scalars as Python floats)."""
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    return arrays, tuple(float(x) for x in scalars)


def coeff_sds(spec: st.StencilSpec, grid_shape, dtype=torch.float32):
    """`TensorSpec`s of the canonical coefficient pair on `grid_shape`:
    the stacked arrays and the scalar vector."""
    return (TensorSpec((spec.n_coeff_arrays,) + tuple(grid_shape), dtype),
            TensorSpec((spec.n_scalars,), dtype))


def extended_coeff_sds(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                       dtype=torch.float32):
    """Global `TensorSpec`s of the hoisted (pre-extended) coefficients:
    every shard's block grows by the deep halo g on z and y, x by g."""
    gs = GridSharding(mesh)
    g = spec.radius * t_block
    nz, ny, nx = grid_shape
    n_z, n_y = gs.counts()
    ext = (nz + 2 * g * n_z, ny + 2 * g * n_y, nx + 2 * g)
    if spec.n_coeff_arrays:
        return (TensorSpec((spec.n_coeff_arrays,) + ext, dtype),
                TensorSpec((spec.n_scalars,), dtype))
    return coeff_sds(spec, grid_shape, dtype)


def local_extended_shape(spec: st.StencilSpec, mesh, grid_shape,
                         t_block: int) -> tuple[int, int, int]:
    """Shape of the extended local block ONE shard's K1 advance runs on:
    local extent plus the deep halo g on z and y and the edge-padded g on
    x. Plan resolution keys on this shape, not the global grid's."""
    gs = GridSharding(mesh)
    g = spec.radius * t_block
    nz, ny, nx = grid_shape
    n_z, n_y = gs.counts()
    return (nz // n_z + 2 * g, ny // n_y + 2 * g, nx + 2 * g)


def _exchanged_shape(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                     compress: bool) -> tuple[int, int, int]:
    """A shard's block as the exchange ships it: x-padded by g when exact,
    unpadded when compressed."""
    g = spec.radius * t_block
    nz, ny, nx = grid_shape
    n_z, n_y = GridSharding(mesh).counts()
    return (nz // n_z, ny // n_y, nx if compress else nx + 2 * g)


def interior_halo_bytes(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                        *, word_bytes: int = 4) -> int:
    """Bytes one exact super-step sends from a shard whose four neighbours
    are all other ranks': `halo.halo_bytes` of the x-padded block the
    exchange ships, per exchanged solution stream (coefficients cross
    once per run)."""
    streams = 2 if spec.time_order == 2 else 1
    return halo.halo_bytes(
        _exchanged_shape(spec, mesh, grid_shape, t_block, False),
        spec.radius * t_block, word_bytes, streams)


def rank_halo_bytes(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                    rank: int, *, word_bytes: int = 4,
                    compress: bool = False) -> int:
    """Bytes rank `rank`'s `halo.Carrier` sends in one super-step: per
    shard it holds, `halo.halo_bytes` over the faces whose neighbour
    another rank holds."""
    gs = GridSharding(mesh)
    owners = gs.owners()
    n_z, n_y = gs.counts()
    shape = _exchanged_shape(spec, mesh, grid_shape, t_block, compress)
    streams = 2 if spec.time_order == 2 else 1
    total = 0
    for iz, iy in gs.cells():
        if owners[iz][iy] != rank:
            continue
        faces = [f for f, (jz, jy) in (("z_lo", (iz - 1, iy)),
                                       ("z_hi", (iz + 1, iy)),
                                       ("y_lo", (iz, iy - 1)),
                                       ("y_hi", (iz, iy + 1)))
                 if 0 <= jz < n_z and 0 <= jy < n_y
                 and owners[jz][jy] != rank]
        total += halo.halo_bytes(shape, spec.radius * t_block, word_bytes,
                                 streams, compress, faces)
    return total


def cap_plan_d_w(spec: st.StencilSpec, plan: MWDPlan,
                 ny_local: int) -> MWDPlan:
    """Clamp a plan's diamond width to a shard's y extent.

    Returns a kernel-valid plan: D_w a multiple of 2R capped at
    `ny_local`, N_F re-clamped to divide it.
    """
    step = 2 * spec.radius
    cap = max(step, ny_local // step * step)
    if plan.d_w <= cap:
        return plan
    n_f = min(max(plan.n_f, 1), cap)
    while cap % n_f:
        n_f -= 1
    return dataclasses.replace(plan, d_w=cap, n_f=n_f)


def resolve_shard_plan(spec: st.StencilSpec, mesh, grid_shape, t_block: int,
                       word_bytes: int = 4,
                       registry=None) -> tuple[MWDPlan, str]:
    """``plan="auto"`` for the K1 route: registry-first against the
    per-shard extended block (`local_extended_shape`), the model on a
    miss, then capped to the shard's y extent. Returns ``(plan, source)``.
    """
    from repro_torch.core import registry as reg
    shape_e = local_extended_shape(spec, mesh, grid_shape, t_block)
    # GridSharding never shards grid-x; the lookup keeps the key honest
    # should a mesh add an explicit "x" axis
    if registry is None:
        registry = reg.default_registry()
    plan, source = registry.resolve(spec, shape_e, word_bytes=word_bytes,
                                    devices_x=mesh.shape.get("x", 1))
    return cap_plan_d_w(spec, plan, shape_e[1]), source


# ---------------------------------------------------------------------------
# exchange of the solution levels
# ---------------------------------------------------------------------------

def _xpadded(spec, g, cur, prev):
    """The x-padded local blocks: what the exact exchange extends and the
    overlapped interior reads (pad-of-concat equals concat-of-pads)."""
    cur_x = _each(cur, lambda b: _padx(b, g))
    prev_x = (_each(prev, lambda b: _padx(b, g))
              if spec.time_order == 2 else cur_x)
    return cur_x, prev_x


class _Exchange:
    """One super-step's deep-halo exchange of the solution levels.

    Starting it x-pads the local blocks (`cur_x`/`prev_x`) and puts the
    exchange on `wire`: the x-padded blocks exactly, or with error-feedback
    state `err` ({"cur": face grid[, "prev": ...]}) the unpadded blocks
    int8-compressed, their residual faces shaped as the reference's
    (`self.err` is then the state for the next super-step). Coefficients
    always exchange exact. `land` waits for the copies and returns the
    x-padded extended blocks ``(cur_e, prev_e)``.

    The exchange runs as phase generators (`halo.exchange_2d_phases`):
    starting it runs the z phase. On one process the y phase follows at
    once, the streams ordering it; a `halo.Carrier` has only staged the z
    slabs it sends (under gloo, device-to-host copies on the
    communication stream), and `land` trades them, lands them and runs the
    y phase, so the overlapped interior launches between the two.
    """

    def __init__(self, spec: st.StencilSpec, g: int, cur, prev, err,
                 wire: halo.Wire):
        self.spec, self.g, self.wire = spec, g, wire
        self.cur_x, self.prev_x = _xpadded(spec, g, cur, prev)
        second = spec.time_order == 2
        self.compressed = err is not None
        self.err = None
        if not self.compressed:
            self._phases = [halo.exchange_2d_phases(self.cur_x, g, wire)]
            if second:
                self._phases.append(
                    halo.exchange_2d_phases(self.prev_x, g, wire))
        else:
            self._phases = [halo.exchange_2d_compressed_phases(
                cur, g, err["cur"], wire)]
            if second:
                self._phases.append(halo.exchange_2d_compressed_phases(
                    prev, g, err["prev"], wire))
        for phases in self._phases:
            next(phases)
        self._done = None
        if not isinstance(wire, halo.Carrier):
            self._finish()

    def _finish(self):
        if self._done is not None:
            return
        with self.wire.deferred():
            self.wire.flush()
            self._done = halo.drive(self._phases, self.wire)
        self.wire.hand_over(self._done)

    def land(self):
        """Wait for the copies; the x-padded extended blocks."""
        self._finish()
        self.wire.land()
        second = self.spec.time_order == 2
        if not self.compressed:
            cur_e = self._done[0]
            return cur_e, (self._done[1] if second else cur_e)
        (cur_e, e_cur) = self._done[0]
        self.err = {"cur": e_cur}
        cur_e = _each(cur_e, lambda b: _padx(b, self.g))
        prev_e = cur_e
        if second:
            prev_e, self.err["prev"] = self._done[1]
            prev_e = _each(prev_e, lambda b: _padx(b, self.g))
        return cur_e, prev_e


def _exchange_state(spec: st.StencilSpec, g: int, cur, prev, err):
    """The synchronous exchange: ``(cur_e, prev_e, new_err)`` with x-padded
    extended blocks, landed."""
    ex = _Exchange(spec, g, cur, prev, err, halo.wire_for(cur))
    cur_e, prev_e = ex.land()
    return cur_e, prev_e, ex.err


def _frame_mask(shape, origin, grid_shape, r: int, device):
    """Dirichlet-frame mask of a block whose cell (0,0,0) sits at `origin`
    (GLOBAL grid coordinates (z, y, x))."""
    masks = []
    for ax, (n, o, n_g) in enumerate(zip(shape, origin, grid_shape)):
        c = torch.arange(n, device=device) + o
        m = (c < r) | (c >= n_g - r)
        view = [1, 1, 1]
        view[ax] = n
        masks.append(m.view(view))
    return (masks[0] | masks[1] | masks[2]).expand(tuple(shape))


def _interior_pad(part: Partition, g: int, x_padded):
    """The overlapped interior's input: the x-padded local block, padded
    by g on the axes that cross no shard boundary (an edge clamp, a local
    computation)."""
    if part.split_z and part.split_y:
        return x_padded
    pads = ((0, 0) if part.split_z else (g, g),
            (0, 0) if part.split_y else (g, g), (0, 0))
    return edge_pad(x_padded, pads)


# ---------------------------------------------------------------------------
# the plain route (plan=None)
# ---------------------------------------------------------------------------

def _local_super_step(spec: st.StencilSpec, t_block: int, gs: GridSharding,
                      grid_shape, cur, prev, coeffs: Hoisted, err=None):
    """Synchronous super-step: exchange, then t_block frame-masked sweeps
    of every extended block."""
    r = spec.radius
    g = r * t_block
    cur_e, prev_e, new_err = _exchange_state(spec, g, cur, prev, err)
    sweep = ir.make_sweep(spec)
    outs_a, outs_b = _outputs(cur), _outputs(cur)
    for iz, iy in gs.local_cells():
        nz_l, ny_l, nx_l = cur[iz][iy].shape
        a = cur_e[iz][iy]
        b = prev_e[iz][iy] if spec.time_order == 2 else a
        arrays = coeffs.block(iz, iy, g)
        frame = _frame_mask(a.shape, (iz * nz_l - g, iy * ny_l - g, -g),
                            grid_shape, r, a.device)
        frame_vals = a
        for _ in range(t_block):
            new = torch.where(frame, frame_vals,
                              sweep(a, b, arrays, coeffs.scalars))
            a, b = new, a
        crop = (slice(g, g + nz_l), slice(g, g + ny_l), slice(g, g + nx_l))
        outs_a[iz][iy], outs_b[iz][iy] = a[crop], b[crop]
    if err is not None:
        return outs_a, outs_b, new_err
    return outs_a, outs_b


def _advance_trapezoid(sweep, a0, b0, arrays, scalars, frame, kept,
                       t_block: int, r: int):
    """t_block frame-masked sweeps computing only the shrinking support of
    `kept`: at sub-step t the sweep runs on kept ⊕ (m + r) and writes back
    kept ⊕ m, m = r*(t_block - t). Bitwise equal to the full-block advance
    on the kept box (a) and on kept ⊕ r one level earlier (b)."""
    (kz0, kz1), (ky0, ky1) = kept
    a, b = a0, b0
    for t in range(1, t_block + 1):
        m = r * (t_block - t)
        z0, z1 = kz0 - m, kz1 + m
        y0, y1 = ky0 - m, ky1 + m
        sub = (slice(z0 - r, z1 + r), slice(y0 - r, y1 + r), slice(None))
        arr = arrays[(slice(None),) + sub] if arrays is not None else None
        new = sweep(a[sub], b[sub], arr, scalars)
        new = torch.where(frame[sub], a0[sub], new)
        nxt = a.clone()
        nxt[z0:z1, y0:y1, :] = new[r:r + (z1 - z0), r:r + (y1 - y0), :]
        a, b = nxt, a
    return a, b


def _advance_block(sweep, a0, b0, arrays, scalars, frame, t_block: int):
    """t_block frame-masked full-block sweeps (the boundary slabs)."""
    a, b = a0, b0
    for _ in range(t_block):
        new = torch.where(frame, a0, sweep(a, b, arrays, scalars))
        a, b = new, a
    return a, b


def _local_super_step_zones(spec: st.StencilSpec, t_block: int,
                            gs: GridSharding, grid_shape, overlap: bool,
                            cur, prev, coeffs: Hoisted, err=None):
    """Zone-split super-step: interior trapezoid + boundary slabs.

    Both schedules run this body. overlap=True reads the interior from the
    pre-exchange local block and launches it before the exchange lands;
    overlap=False lands the exchange first and reads the same-shaped,
    same-valued block sliced from the exchanged state.
    """
    r = spec.radius
    g = r * t_block
    n_z, n_y = gs.counts()
    part = partition_geometry(cur[0][0].shape, g, n_z > 1, n_y > 1)
    sweep = ir.make_sweep(spec)
    ex = _Exchange(spec, g, cur, prev, err, halo.wire_for(cur))
    if not overlap:
        cur_e, prev_e = ex.land()
    ioz, ioy = part.interior_origin
    (ikz0, ikz1), (iky0, iky1) = part.interior_kept
    azs = slice(g, g + part.local_shape[0]) if part.split_z else slice(None)
    ays = slice(g, g + part.local_shape[1]) if part.split_y else slice(None)
    interior = {}
    for iz, iy in gs.local_cells():
        nz_l, ny_l, nx_l = part.local_shape
        if overlap:
            cur_l = _interior_pad(part, g, ex.cur_x[iz][iy])
            prev_l = (_interior_pad(part, g, ex.prev_x[iz][iy])
                      if spec.time_order == 2 else cur_l)
        else:
            cur_l = cur_e[iz][iy][azs, ays]
            prev_l = (prev_e[iz][iy][azs, ays] if spec.time_order == 2
                      else cur_l)
        arrays = coeffs.block(iz, iy, g, azs, ays)
        frame = _frame_mask(cur_l.shape, (iz * nz_l + ioz, iy * ny_l + ioy,
                                          -g), grid_shape, r, cur_l.device)
        a_i, b_i = _advance_trapezoid(sweep, cur_l, prev_l, arrays,
                                      coeffs.scalars, frame,
                                      part.interior_kept, t_block, r)
        xs = slice(g, g + nx_l)
        interior[iz, iy] = (a_i[ikz0:ikz1, iky0:iky1, xs],
                            b_i[ikz0:ikz1, iky0:iky1, xs])
    if overlap:
        cur_e, prev_e = ex.land()
    outs_a, outs_b = _outputs(cur), _outputs(cur)
    for iz, iy in gs.local_cells():
        nz_l, ny_l, nx_l = part.local_shape
        xs = slice(g, g + nx_l)
        outs = {}
        for zn in part.zones:
            ca = cur_e[iz][iy][zn.z, zn.y]
            pa = prev_e[iz][iy][zn.z, zn.y]
            arrays = coeffs.block(iz, iy, g, zn.z, zn.y)
            fr = _frame_mask(ca.shape, (iz * nz_l + zn.origin[0],
                                        iy * ny_l + zn.origin[1], -g),
                             grid_shape, r, ca.device)
            a_z, b_z = _advance_block(sweep, ca, pa, arrays, coeffs.scalars,
                                      fr, t_block)
            (az0, az1), (ay0, ay1) = zn.kept
            outs[zn.name] = (a_z[az0:az1, ay0:ay1, xs],
                             b_z[az0:az1, ay0:ay1, xs])
        outs_a[iz][iy], outs_b[iz][iy] = _assemble(part, interior[iz, iy],
                                                   outs)
    if err is not None:
        return outs_a, outs_b, ex.err
    return outs_a, outs_b


def _assemble(part: Partition, interior, outs):
    """Concatenate zone outputs back into the full local block (both
    levels)."""
    def one(level):
        mid = interior[level]
        if part.split_y:
            mid = torch.cat([outs["y_lo"][level], mid, outs["y_hi"][level]],
                            dim=1)
        if part.split_z:
            mid = torch.cat([outs["z_lo"][level], mid, outs["z_hi"][level]],
                            dim=0)
        return mid
    return one(0), one(1)


# ---------------------------------------------------------------------------
# the K1 route (plan=MWDPlan)
# ---------------------------------------------------------------------------

def block_interior(spec: st.StencilSpec, grid_shape, g: int, block_shape,
                   origin_zy) -> tuple[int, ...]:
    """K1's runtime `interior` for a block of the extended local grid
    whose cell (0, 0) sits at GLOBAL ``origin_zy``: the global Dirichlet
    frame clipped into the block on z and y, the frame on x (the block is
    x-padded by g)."""
    r = spec.radius
    nz_g, ny_g, nx_g = grid_shape
    bnz, bny = block_shape[0], block_shape[1]
    oz, oy = origin_zy

    def clip(v, n):
        return min(max(v, 0), n)

    return (clip(r - oz, bnz), clip(nz_g - r - oz, bnz),
            clip(r - oy, bny), clip(ny_g - r - oy, bny),
            g + r, g + nx_g - r)


def _mwd_block(spec: st.StencilSpec, plan: MWDPlan, scalars, t_block: int,
               grid_shape, g: int, a, b, arrays, origin_zy):
    """One K1 advance of t_block steps on a (sub-)block of the extended
    local grid.

    `origin_zy` holds the GLOBAL grid coordinates of block cell (0, 0); the
    global Dirichlet frame is clipped into the block as K1's runtime
    `interior` (`block_interior`), and the diamonds tessellate the block's
    whole y extent (``y_domain = (0, bny)``) so halo cells advance the
    intermediate levels the kept cells need. The plan's diamond width is
    re-capped to the block's own y extent.
    """
    if spec.time_order == 2:
        # frame cells must read back as cur at EVERY time parity (the plain
        # route re-imposes them each step); sync the odd-parity level too
        fr = _frame_mask(a.shape, (origin_zy[0], origin_zy[1], -g),
                         grid_shape, spec.radius, a.device)
        b = torch.where(fr, a, b)
    bny = a.shape[1]
    pb = cap_plan_d_w(spec, plan, bny)
    return stencil_mwd.mwd_run(
        spec, (a, b), arrays, scalars, t_block, d_w=pb.d_w, n_f=pb.n_f,
        fused=pb.fused,
        interior=block_interior(spec, grid_shape, g, a.shape, origin_zy),
        y_domain=(0, bny))


def _local_super_step_mwd(spec: st.StencilSpec, plan: MWDPlan, t_block: int,
                          gs: GridSharding, grid_shape, cur, prev,
                          coeffs: Hoisted, err=None):
    """K1 super-step: one K1 advance of t_block steps per shard per halo
    exchange, on the whole extended block."""
    r = spec.radius
    g = r * t_block
    cur_e, prev_e, new_err = _exchange_state(spec, g, cur, prev, err)
    outs_a, outs_b = _outputs(cur), _outputs(cur)
    for iz, iy in gs.local_cells():
        nz_l, ny_l, nx_l = cur[iz][iy].shape
        a, b = _mwd_block(spec, plan, coeffs.scalars, t_block, grid_shape, g,
                          cur_e[iz][iy], prev_e[iz][iy],
                          coeffs.block(iz, iy, g),
                          (iz * nz_l - g, iy * ny_l - g))
        crop = (slice(g, g + nz_l), slice(g, g + ny_l), slice(g, g + nx_l))
        outs_a[iz][iy], outs_b[iz][iy] = a[crop], b[crop]
    if err is not None:
        return outs_a, outs_b, new_err
    return outs_a, outs_b


def _local_super_step_overlap_mwd(spec: st.StencilSpec, plan: MWDPlan,
                                  t_block: int, gs: GridSharding, grid_shape,
                                  cur, prev, coeffs: Hoisted, err=None):
    """Overlapped K1 super-step: one K1 advance per zone.

    The exchange starts on the communication streams; the interior
    advances (on the pre-exchange local blocks) go on the compute stream
    meanwhile; each boundary zone's advance on its 3g-thick slab waits
    for the landed halos. Full-block advances with the kept-box crop make
    the assembly bitwise equal to the synchronous schedule.
    """
    r = spec.radius
    g = r * t_block
    n_z, n_y = gs.counts()
    part = partition_geometry(cur[0][0].shape, g, n_z > 1, n_y > 1)
    nz_l, ny_l, nx_l = part.local_shape
    xs = slice(g, g + nx_l)
    ex = _Exchange(spec, g, cur, prev, err, halo.wire_for(cur))
    ioz, ioy = part.interior_origin
    (ikz0, ikz1), (iky0, iky1) = part.interior_kept
    azs = slice(g, g + nz_l) if part.split_z else slice(None)
    ays = slice(g, g + ny_l) if part.split_y else slice(None)
    interior = {}
    for iz, iy in gs.local_cells():
        cur_l = _interior_pad(part, g, ex.cur_x[iz][iy])
        prev_l = (_interior_pad(part, g, ex.prev_x[iz][iy])
                  if spec.time_order == 2 else cur_l)
        a_i, b_i = _mwd_block(spec, plan, coeffs.scalars, t_block,
                              grid_shape, g, cur_l, prev_l,
                              coeffs.block(iz, iy, g, azs, ays),
                              (iz * nz_l + ioz, iy * ny_l + ioy))
        interior[iz, iy] = (a_i[ikz0:ikz1, iky0:iky1, xs],
                            b_i[ikz0:ikz1, iky0:iky1, xs])
    cur_e, prev_e = ex.land()
    outs_a, outs_b = _outputs(cur), _outputs(cur)
    for iz, iy in gs.local_cells():
        outs = {}
        for zn in part.zones:
            a_z, b_z = _mwd_block(spec, plan, coeffs.scalars, t_block,
                                  grid_shape, g, cur_e[iz][iy][zn.z, zn.y],
                                  prev_e[iz][iy][zn.z, zn.y],
                                  coeffs.block(iz, iy, g, zn.z, zn.y),
                                  (iz * nz_l + zn.origin[0],
                                   iy * ny_l + zn.origin[1]))
            (az0, az1), (ay0, ay1) = zn.kept
            outs[zn.name] = (a_z[az0:az1, ay0:ay1, xs],
                             b_z[az0:az1, ay0:ay1, xs])
        outs_a[iz][iy], outs_b[iz][iy] = _assemble(part, interior[iz, iy],
                                                   outs)
    if err is not None:
        return outs_a, outs_b, ex.err
    return outs_a, outs_b


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------

def make_super_step(spec: st.StencilSpec, mesh, grid_shape, t_block: int, *,
                    plan: MWDPlan | None = None, compress: bool = False,
                    overlap: bool | str = False):
    """Build the distributed super-step on shard grids.

    The step is ``(cur, prev, coeffs) -> (cur, prev)``, or with
    compress=True ``(cur, prev, coeffs, err) -> (cur, prev, err')``, where
    `err` is the residual-face state from `init_halo_error_global` (thread
    err' into the next super-step). `coeffs` is the `Hoisted` output of
    `make_coeff_extender`: coefficients are time-invariant, so they are
    exchanged once per run (a partial final super-step crops them).

    plan: each shard advances by K1 (`_mwd_block`) instead of t_block
    plain sweeps. overlap=True splits each shard into a halo-independent
    interior and boundary zones completed from the landed halos (bitwise
    equal to the synchronous schedule); "auto" falls back to synchronous
    when the shards are too small.
    """
    if overlap == "auto":
        overlap = overlap_feasible(spec, mesh, grid_shape, t_block)
    validate_super_step(spec, mesh, grid_shape, t_block, overlap=bool(overlap))
    gs = GridSharding(mesh)
    if plan is not None:
        if overlap:
            def local(cur, prev, coeffs, err=None):
                return _local_super_step_overlap_mwd(
                    spec, plan, t_block, gs, grid_shape, cur, prev, coeffs,
                    err)
        else:
            def local(cur, prev, coeffs, err=None):
                return _local_super_step_mwd(
                    spec, plan, t_block, gs, grid_shape, cur, prev, coeffs,
                    err)
    elif overlap_feasible(spec, mesh, grid_shape, t_block):
        # both schedules share the zone pipeline, so every zone runs at the
        # same shape in either (see _local_super_step_zones)
        def local(cur, prev, coeffs, err=None):
            return _local_super_step_zones(spec, t_block, gs, grid_shape,
                                           bool(overlap), cur, prev, coeffs,
                                           err)
    else:
        def local(cur, prev, coeffs, err=None):
            return _local_super_step(spec, t_block, gs, grid_shape, cur,
                                     prev, coeffs, err)
    if compress:
        return local
    return lambda cur, prev, coeffs: local(cur, prev, coeffs)


def init_halo_error_global(spec: st.StencilSpec, mesh, grid_shape,
                           t_block: int):
    """Zero error-feedback faces for the compressed super-step: one
    `halo.init_halo_error` dict per shard of this process, on its device
    (None for another rank's shard), per exchanged stream ({"cur": grid} +
    "prev" for second-order ops)."""
    gs = GridSharding(mesh)
    g = spec.radius * t_block
    nz, ny, nx = grid_shape
    n_z, n_y = gs.counts()
    local = (nz // n_z, ny // n_y, nx)
    devs = gs.devices()
    mine = set(gs.local_cells())

    def faces():
        return _grid(gs, lambda iz, iy: halo.init_halo_error(
            local, g, devs[iz][iy]) if (iz, iy) in mine else None)

    err = {"cur": faces()}
    if spec.time_order == 2:
        err["prev"] = faces()
    return err


def run_distributed(spec: st.StencilSpec, mesh, state, coeffs, n_steps: int,
                    t_block: int = 2, *, plan: MWDPlan | str | None = None,
                    compress: bool = False, overlap: bool | str = False):
    """Shard the problem over the mesh and advance n_steps (super-stepped).

    `state` and `coeffs` are global (the op's packed convention); the
    result is the global ``(cur, prev)`` on the first mesh device.
    Coefficients are exchanged once (hoisted) and feed every super-step,
    a partial final one (t_block not dividing n_steps) included, which
    crops them and runs the synchronous schedule (restarting compressed
    residuals at zero: the faces are shaped by its own g).

    overlap=True runs the interior/boundary split (bitwise equal to the
    synchronous schedule); "auto" falls back to synchronous when the
    shards are too small. Overlap engages for full-depth super-steps with
    t_block >= 2. compress=True ships solution halos int8-compressed with
    error feedback.

    plan: an `MWDPlan` or "auto" runs every super-step as K1 advances per
    shard (or per zone); "auto" resolves registry-first against the
    per-shard extended block (`resolve_shard_plan`). An explicit plan
    whose D_w exceeds that block's y extent is rejected. plan=None runs
    the plain sweeps.

    Across processes every rank calls this with the same global problem
    (the reference's processes each pass the same host value) and gets
    the global ``(cur, prev)`` on its first mesh device; "auto" resolves
    on rank 0 alone (one tuner, one registry writer) and is broadcast.
    """
    gs = GridSharding(mesh)
    cur, prev = state
    grid_shape = tuple(cur.shape)
    shape_e = local_extended_shape(spec, mesh, grid_shape, t_block)
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(
                f"plan must be an MWDPlan or 'auto', got {plan!r}")
        resolved = None
        if not gs.multiprocess or process.process_index() == 0:
            resolved = resolve_shard_plan(spec, mesh, grid_shape, t_block,
                                          word_bytes=cur.element_size())
        if gs.multiprocess:
            resolved = process.broadcast_object(resolved)
        plan, _source = resolved
    elif plan is not None and plan.d_w > shape_e[1]:
        raise ValueError(
            f"plan d_w={plan.d_w} exceeds the per-shard extended y extent "
            f"{shape_e[1]} (global ny={cur.shape[1]} over "
            f"{mesh.shape[gs.y_axis]} shards); tune against "
            f"local_extended_shape() or pass plan='auto'")
    validate_super_step(spec, mesh, grid_shape, t_block)
    cur_g = gs.shard(cur)
    prev_g = gs.shard(prev) if spec.time_order == 2 else cur_g
    arrays, scalars = canonical_coeffs(spec, coeffs)
    hoisted = make_coeff_extender(spec, t_block)(
        (gs.shard(arrays) if arrays is not None else None, scalars))
    ovl = overlap if t_block > 1 else False
    step = make_super_step(spec, mesh, grid_shape, t_block, plan=plan,
                           compress=compress, overlap=ovl)
    err = (init_halo_error_global(spec, mesh, grid_shape, t_block)
           if compress else None)
    done = 0
    while done < n_steps:
        tb = min(t_block, n_steps - done)
        if tb != t_block:
            # trailing partial super-step: synchronous schedule
            step = make_super_step(spec, mesh, grid_shape, tb, plan=plan,
                                   compress=compress, overlap=False)
            if compress:    # residual faces are g-shaped: restart at zero
                err = init_halo_error_global(spec, mesh, grid_shape, tb)
        if compress:
            cur_g, prev_g, err = step(cur_g, prev_g, hoisted, err)
        else:
            cur_g, prev_g = step(cur_g, prev_g, hoisted)
        done += tb
    if n_steps == 0:
        return cur, prev
    return gs.gather(cur_g), gs.gather(prev_g)
