"""Analytic performance models of the port, priced on a CUDA card.

The port of `repro.core.models`, re-derived for the H100 where the TPU's
terms do not apply:

* Eq. 2/3  — cache-block size (`cache_block_bytes`, kept for the paper's
             figures); the fit the tuner prunes with is `mwd_smem_plan`,
             the Python twin of K1's own launch choice (``csrc/mwd.cu``).
* Eq. 4/5  — code balance of the MWD pass, the spatial and ghost-zone
             baselines.
* ECM      — {T_compute || T_smem || T_hbm} with a launch-latency floor.
* Roofline — compute / memory / latency terms; no collective term yet.
* K1 model — `k1_predict`: the schedule's bytes over the HBM rate, the
             flops over the f32 peak, the cluster barriers each CTA passes
             times the waves of resident clusters, and one launch per
             diamond row. The tuner scores plans with it
             (`core.autotune.model_score`).

Every function takes the machine model as a `core.specs.DeviceSpec`
(``chip=None`` resolves the process default). The traffic bounds of K2 and
K3 (`sweep_tile_bytes`, `fused_window_bytes`) live in their kernels'
wrappers and are reached through here, so `chip_smoke.py`, the traffic
counters and the model share them.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import specs as devspecs
from repro_torch.core.mwd import barrier_schedule, k1_geometry
from repro_torch.core.precision import DEFAULT_WORD_BYTES
from repro_torch.core.stencils import StencilSpec
from repro_torch.core.tiling import wavefront_width


# ---------------------------------------------------------------------------
# Eq. 2/3: cache block size
# ---------------------------------------------------------------------------

def cache_block_bytes(spec: StencilSpec, d_w: int, n_f: int, n_xb: int) -> float:
    """Eq. 3 (general R): bytes of one wavefront-diamond cache block.

    n_xb: bytes along the leading dimension held per (y,z) cell (the
    paper's full x line). N_D is the paper's stream count for block sizing:
    the solution levels + coefficient arrays resident per cell.
    """
    r = spec.radius
    n_d = spec.bytes_per_cell
    w_w = wavefront_width(d_w, r, n_f)
    return n_xb * (n_d * d_w * (d_w / 2.0 - r + n_f) + 2.0 * r * (d_w + w_w))


# ---------------------------------------------------------------------------
# Eq. 4/5: code balance (bytes / LUP)
# ---------------------------------------------------------------------------

def code_balance(spec: StencilSpec, d_w: int,
                 word_bytes: int = DEFAULT_WORD_BYTES) -> float:
    """Eq. 5: B_C = word*R*[(2*D_w - 2R) + (N_D*D_w + 2R)] / D_w**2  bytes/LUP."""
    r = spec.radius
    n_d = spec.n_streams
    lups = d_w * d_w / (2.0 * r)
    words = (2.0 * d_w - 2.0 * r) + (n_d * d_w + 2.0 * r)
    return word_bytes * words / lups


def spatial_code_balance(spec: StencilSpec,
                         word_bytes: int = DEFAULT_WORD_BYTES) -> float:
    """Optimal spatial-blocking code balance, bytes/LUP (the MWD baseline)."""
    return spec.spatial_code_balance(word_bytes)


def ghostzone_code_balance(spec: StencilSpec, t_b: int, block_y: int,
                           block_z: int,
                           word_bytes: int = DEFAULT_WORD_BYTES) -> float:
    """Code balance of the ghost-zone (overlapped) fused kernel.

    Each T_b-step block reads (block + 2*R*T_b halo)*N_D streams and writes
    the block once; redundant halo cells are re-read by neighbours.
    """
    r, n_d = spec.radius, spec.n_streams
    g = 2 * r * t_b
    reads = n_d * (block_y + g) * (block_z + g)
    writes = 2.0 * block_y * block_z
    lups = t_b * block_y * block_z
    return word_bytes * (reads + writes) / lups


def ghostzone_redundancy(radius: int, t_b: int, block_y: int, block_z: int) -> float:
    """Redundant-compute multiplier of the ghost-zone kernel (>= 1)."""
    total = 0.0
    for t in range(t_b):
        g = 2 * radius * (t_b - 1 - t)
        total += (block_y + g) * (block_z + g)
    return total / (t_b * block_y * block_z)


def mwd_tile_bytes(spec: StencilSpec, d_w: int, n_f: int, nz: int, nx: int,
                   word_bytes: int = DEFAULT_WORD_BYTES) -> float:
    """Bytes ONE tile of the reference's schedule moves over its sweep.

    Window streams in (both parities + coefficient streams, one (N_F,
    D_w+2R, nx+2R) slab per wavefront step) plus strip emissions out (both
    parities, (N_F, D_w) per step once the pipeline fills). Kept for the
    paper's figures; K1's own bytes are `mwd_schedule_bytes`.
    """
    r = spec.radius
    n_j = -(-(r + nz + d_w) // n_f)          # wavefront steps along z
    nxp = nx + 2 * r
    wy = d_w + 2 * r
    n_streams_in = 2 + spec.n_coeff_arrays   # both parities + coeff streams
    per_step_in = n_streams_in * n_f * wy * nxp * word_bytes
    out_steps = max(0, n_j - d_w // n_f)
    per_step_out = 2 * n_f * d_w * nxp * word_bytes
    return float(n_j * per_step_in + out_steps * per_step_out)


# ---------------------------------------------------------------------------
# Launch dispatch amortized over a batch
# ---------------------------------------------------------------------------

def batch_amortized_time(t_item_s: float, batch: int,
                         t_dispatch_s: float | None = None) -> float:
    """Wall time of ONE launch advancing `batch` independent grids.

    The steady-state terms scale with B; the dispatch (default: the spec's
    measured `launch_s`) is paid once. Sequential serving of the same B
    requests costs ``batch * (t_item_s + t_dispatch_s)``.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if t_dispatch_s is None:
        t_dispatch_s = devspecs.current_spec().launch_s
    return batch * t_item_s + t_dispatch_s


def batch_amortization(t_item_s: float, batch: int,
                       t_dispatch_s: float | None = None) -> float:
    """Modeled throughput multiplier of one B-batch launch over B launches.

    ``B*(t + T_d) / (B*t + T_d)``: >= 1, -> 1 as t dominates and -> B as
    the dispatch dominates.
    """
    if t_dispatch_s is None:
        t_dispatch_s = devspecs.current_spec().launch_s
    return (batch * (t_item_s + t_dispatch_s)
            / batch_amortized_time(t_item_s, batch, t_dispatch_s))


# ---------------------------------------------------------------------------
# ECM model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EcmPrediction:
    """ECM runtime terms for one LUP batch (all in seconds)."""

    t_compute: float          # f32 work at the card's peak
    t_smem: float             # shared-memory traffic, all SMs together
    t_hbm: float              # HBM traffic at code balance B_C
    lups: float
    t_latency: float = 0.0    # the launch floor
    hbm_bytes: float = 0.0    # HBM traffic the prediction priced

    @property
    def t_total(self) -> float:
        """Steady-state runtime bound: max of the overlapped terms."""
        return max(self.t_compute, self.t_smem, self.t_hbm, self.t_latency)

    @property
    def dominant(self) -> str:
        """The binding term: "compute", "smem", "hbm" or "latency"."""
        terms = {"compute": self.t_compute, "smem": self.t_smem,
                 "hbm": self.t_hbm, "latency": self.t_latency}
        return max(terms, key=terms.get)

    @property
    def glups(self) -> float:
        """Predicted throughput in giga lattice updates per second."""
        return self.lups / self.t_total / 1e9


def ecm_predict(spec: StencilSpec, code_balance_bytes: float, lups: float,
                chip: devspecs.DeviceSpec | None = None,
                word_bytes: int = DEFAULT_WORD_BYTES,
                redundancy: float = 1.0) -> EcmPrediction:
    """ECM prediction for `lups` updates at the given code balance.

    `redundancy` > 1 prices overlapped (ghost-zone) kernels, which
    recompute halo cells. Shared-memory traffic is (n_streams + 1) words per
    LUP; the latency floor is one launch.
    """
    chip = chip or devspecs.current_spec()
    flops = spec.flops_per_lup * lups * redundancy
    smem_bytes = (spec.n_streams + 1) * word_bytes * lups * redundancy
    hbm_bytes = code_balance_bytes * lups
    return EcmPrediction(
        t_compute=flops / chip.peak_flops_f32,
        t_smem=smem_bytes / chip.smem_bw,
        t_hbm=hbm_bytes / chip.hbm_bw,
        lups=lups,
        t_latency=chip.launch_s if hbm_bytes > 0 else 0.0,
        hbm_bytes=hbm_bytes,
    )


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """All terms in seconds; inputs are PER-DEVICE quantities."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    t_latency: float = 0.0

    @property
    def dominant(self) -> str:
        """Binding term: "compute", "memory", "collective" or "latency"."""
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective, "latency": self.t_latency}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-limited runtime: the largest of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective,
                   self.t_latency)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the binding roofline achievable with perfect overlap."""
        s = self.t_compute + self.t_memory + self.t_collective
        s = max(s, self.t_latency)
        return self.t_bound / s if s else 0.0


def roofline(flops_per_device: float, bytes_per_device: float,
             coll_bytes_per_device: float,
             chip: devspecs.DeviceSpec | None = None) -> RooflineTerms:
    """The roofline terms for per-device FLOPs and bytes.

    Compute is priced at the tensor-core peak, as the reference prices its
    matrix unit. The spec has no interconnect yet, so the collective term
    is 0 whatever `coll_bytes_per_device` says. A transfer under the
    spec's ``latency_bytes`` reports "latency".
    """
    chip = chip or devspecs.current_spec()
    return RooflineTerms(
        t_compute=flops_per_device / chip.peak_flops_bf16,
        t_memory=bytes_per_device / chip.hbm_bw,
        t_collective=0.0,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        t_latency=chip.launch_s if bytes_per_device > 0 else 0.0,
    )


# ---------------------------------------------------------------------------
# K1's shared-memory fit: the twin of choose() and smem_bytes() in mwd.cu
# ---------------------------------------------------------------------------

MWD_SLAB_TARGET = 64    # x columns per CTA the launcher aims for
MWD_MAX_T = 64          # in-tile updates per pass the kernel takes
# per_sm() in mwd.cu: each block's static shared memory (sizeof(Op) of
# stencil_cell.cuh, 2600 bytes at 128 taps and 64 groups) plus 2048 for
# its other tables and the runtime's reserve
MWD_BLOCK_OVERHEAD = 2600 + 2048


@dataclasses.dataclass(frozen=True)
class SmemPlan:
    """K1's launch choice for one problem, as ``csrc/mwd.cu`` makes it.

    cluster (CTAs per tile), slab (x columns per CTA), stage (coefficient
    streams staged in shared memory), threads, smem_bytes (dynamic shared
    memory per CTA), per_sm (CTAs of that size one SM holds), depth and
    cdepth (parity and coefficient ring depths in z rows).
    """

    cluster: int
    slab: int
    stage: int
    threads: int
    smem_bytes: int
    per_sm: int
    depth: int
    cdepth: int


def _round16(v: int) -> int:
    return (v + 15) & ~15


def mwd_smem_plan(op: StencilSpec, d_w: int, n_f: int, nx: int,
                  word: int = DEFAULT_WORD_BYTES,
                  chip: devspecs.DeviceSpec | None = None) -> SmemPlan | None:
    """K1's slab, cluster, staging and shared memory for grids `nx` wide.

    The Python twin of ``choose()`` and ``smem_bytes()`` in
    ``csrc/mwd.cu``, at the default interior (x width ``nx - 2R``). None
    where the kernel refuses with E_SMEM (no cluster of at most
    ``chip.max_cluster`` CTAs holds the rings) or where the plan is not a
    K1 plan (2R or n_f not dividing d_w, more than `MWD_MAX_T` updates a
    pass).
    """
    chip = chip or devspecs.current_spec()
    r = op.radius
    if d_w % (2 * r) or n_f < 1 or d_w % n_f:
        return None
    t = d_w // r
    if t > MWD_MAX_T:
        return None
    ahead = 1 if t >= 4 else 2          # keep >= 4 updates over a load
    depth = (ahead + 1) * n_f + t * r + r
    cdepth = (ahead + 1) * n_f + r * (t - 1)
    wy = d_w + 2 * r
    e = 16 // word                      # elements per 16 bytes
    tab = _round16(depth * len(op.taps) * 4)
    n_arr = op.n_coeff_arrays

    def smem(slab: int, stage: bool) -> int:
        wx = (slab + 2 * r + e - 1) // e * e
        b = tab + _round16(2 * depth * wy * wx * word)
        return b + (n_arr * cdepth * d_w * slab * word if stage else 0)

    def per_sm(b: int) -> int:
        return chip.smem_sm_bytes // (b + MWD_BLOCK_OVERHEAD)

    nxr = max(nx - 2 * r, 0)
    c_min = max(1, -(-nxr // MWD_SLAB_TARGET))
    for c in range(c_min, chip.max_cluster + 1):
        slab = max(-(-nxr // c) + e - 1, e) // e * e
        cl = max(1, -(-nxr // slab))
        if cl > chip.max_cluster or (cl > 1 and slab < r):
            break
        plain = smem(slab, False)
        staged = smem(slab, True) if n_arr else -1
        stage = (0 <= staged <= chip.smem_block_bytes
                 and per_sm(staged) >= per_sm(plain))
        b = staged if stage else plain
        if b > chip.smem_block_bytes:
            continue
        return SmemPlan(cluster=cl, slab=slab, stage=int(stage),
                        threads=256 if per_sm(b) >= 2 else 512,
                        smem_bytes=b, per_sm=per_sm(b), depth=depth,
                        cdepth=cdepth)
    return None


def smem_fits(op: StencilSpec, d_w: int, n_f: int, nx: int,
              word: int = DEFAULT_WORD_BYTES,
              chip: devspecs.DeviceSpec | None = None) -> bool:
    """Whether K1 launches the plan on grids `nx` wide: `mwd_smem_plan`
    finds rings that fit and at least one such CTA fits an SM by the
    kernel's own count (where it counts none, the occupancy API decides
    and may refuse the launch)."""
    plan = mwd_smem_plan(op, d_w, n_f, nx, word, chip)
    return plan is not None and plan.per_sm >= 1


# ---------------------------------------------------------------------------
# K1's time model
# ---------------------------------------------------------------------------

def mwd_schedule_bytes(op: StencilSpec, grid_shape, d_w: int, n_rows: int,
                       word: int = DEFAULT_WORD_BYTES) -> float:
    """HBM bytes of K1's schedule if no tile reuses another's bytes.

    Per diamond row (one launch): both parity grids read over the windows,
    (D_w + 2R)/D_w times, every coefficient stream once, both grids
    written.
    """
    cells = math.prod(grid_shape)
    r = op.radius
    grids = n_rows * (2 * (d_w + 2 * r) / d_w + op.n_coeff_arrays + 2)
    return grids * cells * word


@dataclasses.dataclass(frozen=True)
class K1Prediction:
    """The K1 model's terms for one advance (seconds, and what they count).

    `t_total` is ``max(t_bytes, t_flops) + t_barrier + t_launch``: bytes
    and flops overlap, a CTA at a cluster barrier streams nothing, and the
    rows run one launch after another.
    """

    t_bytes: float
    t_flops: float
    t_barrier: float
    t_launch: float
    hbm_bytes: float
    flops: float
    barriers: int          # barrier-ended phases on the critical path
    launches: int
    lups: float
    smem: SmemPlan | None

    @property
    def t_total(self) -> float:
        """Predicted time of the advance."""
        return max(self.t_bytes, self.t_flops) + self.t_barrier + self.t_launch

    @property
    def dominant(self) -> str:
        """The largest term: "bytes", "flops", "barrier" or "launch"."""
        terms = {"bytes": self.t_bytes, "flops": self.t_flops,
                 "barrier": self.t_barrier, "launch": self.t_launch}
        return max(terms, key=terms.get)


def k1_waves(smem: SmemPlan, exchange: bool, tiles: int,
             chip: devspecs.DeviceSpec) -> int:
    """Waves of resident clusters one row of `tiles` tiles takes.

    With halo exchange a tile's CTAs run as one cluster, else as single
    CTAs; the card holds ``n_sm * per_sm`` CTAs (the occupancy API's count
    of resident clusters may be lower, as clusters keep to a GPC).
    """
    ctas = chip.n_sm * smem.per_sm
    if exchange:
        return -(-tiles // max(1, ctas // smem.cluster))
    return -(-tiles * smem.cluster // ctas)


def k1_predict(op: StencilSpec, grid_shape, d_w: int, n_f: int,
               n_steps: int, *, fused: bool = True,
               word: int = DEFAULT_WORD_BYTES,
               chip: devspecs.DeviceSpec | None = None) -> K1Prediction:
    """K1's time for one `ops.mwd` advance of one grid, term by term.

    Bytes: `mwd_schedule_bytes`; the per-row mode also copies both padded
    grids before every row and runs every tile, the inactive ones too.
    Flops: ``flops_per_lup * LUPs`` over the f32 peak. Barriers: per row,
    the most cluster barriers a CTA passes (`core.mwd.barrier_schedule`)
    times the waves of resident clusters (`k1_waves`), times
    ``chip.cluster_barrier_s``. Launches: one per diamond row, times
    ``chip.launch_s``. Raises ValueError where `mwd_smem_plan` finds no
    fit; the host side of `ops.mwd` (padding, cropping) is not modeled.
    """
    chip = chip or devspecs.current_spec()
    nz, ny, nx = grid_shape
    smem = mwd_smem_plan(op, d_w, n_f, nx, word, chip)
    if smem is None:
        raise ValueError(f"{op.name}: no K1 launch fits d_w={d_w}, "
                         f"n_f={n_f} at nx={nx}, word={word}")
    geo = k1_geometry(op.radius, grid_shape, d_w, n_f, n_steps, fused=fused)
    comp = geo.comp
    lups = float(nz * ny * nx * n_steps)
    flops = op.flops_per_lup * lups
    n_rows = comp.n_rows
    hbm = mwd_schedule_bytes(op, grid_shape, d_w, n_rows, word)
    barriers = 0
    if n_rows:
        push, per_cta = barrier_schedule(geo)
        exchange = bool(push.any())
        for i in range(n_rows):
            tiles = int(comp.active[i].sum()) if fused else comp.n_tiles
            barriers += (k1_waves(smem, exchange, tiles, chip)
                         * int(per_cta[i].max()))
        if not fused:
            hbm *= comp.n_rows * comp.n_tiles / max(comp.n_active, 1)
            padded = ((geo.n_j * n_f) * (ny + 2 * geo.pads[1])
                      * (nx + 2 * geo.pads[2]))
            hbm += n_rows * 2 * 2 * padded * word     # clones, read + write
    return K1Prediction(
        t_bytes=hbm / chip.hbm_bw, t_flops=flops / chip.peak_flops_f32,
        t_barrier=barriers * chip.cluster_barrier_s,
        t_launch=n_rows * chip.launch_s, hbm_bytes=hbm, flops=flops,
        barriers=barriers, launches=n_rows, lups=lups, smem=smem)


# ---------------------------------------------------------------------------
# K2's and K3's traffic bounds (their wrappers hold the tilings)
# ---------------------------------------------------------------------------

def sweep_tile_bytes(op: StencilSpec, grid_shape, bz: int = 8,
                     word: int = DEFAULT_WORD_BYTES) -> int:
    """HBM bytes of one K2 step at its own tiling if no CTA reuses another's
    bytes (`kernels.stencil_sweep.tile_bytes`)."""
    from repro_torch.kernels import stencil_sweep as sw
    plan = sw.choose_tile(op, tuple(grid_shape), bz, word)
    return sw.tile_bytes(op, tuple(grid_shape), plan, word)


def fused_window_bytes(op: StencilSpec, grid_shape, t_block: int,
                       bz: int = 16, by: int = 16,
                       word: int = DEFAULT_WORD_BYTES) -> int:
    """HBM bytes of one K3 pass of `t_block` steps at its own tiling if each
    tile reads its window once (`kernels.stencil_fused.window_bytes`)."""
    from repro_torch.kernels import stencil_fused as fu
    steps = fu.launch_steps(op, t_block, by, grid_shape[2], word)
    plan = fu.choose_tile(op, steps[0], by, grid_shape[2], word)
    return fu.window_bytes(op, tuple(grid_shape), t_block, bz, by, plan.bx,
                           word, ty=plan.ty)
