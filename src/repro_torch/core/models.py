"""Analytic performance models of the port, priced on a CUDA card.

The port of `repro.core.models`, re-derived for the H100 where the TPU's
terms do not apply:

* Eq. 2/3  — cache-block size (`cache_block_bytes`, kept for the paper's
             figures); the fit the tuner prunes with is `mwd_smem_plan`,
             the Python twin of K1's own launch choice (``csrc/mwd.cu``).
* Eq. 4/5  — code balance of the MWD pass, the spatial and ghost-zone
             baselines.
* ECM      — {T_compute || T_smem || T_hbm} with a launch-latency floor.
* Roofline — compute / memory / collective / latency terms; the
             collective term prices the bytes a device sends over its
             NVLink links' one-way rate (the spec's ``ici_*`` fields).
* K1 model — `k1_predict`: the schedule's bytes over the HBM rate, the
             flops over the f32 peak, the barrier-ended phases each CTA
             passes times the waves of resident clusters at the costs
             `fit_k1` measures, and one launch per diamond row, at the
             kernel's own cluster size or a requested one (``cluster=``,
             Figs. 16-18). The tuner scores plans with it
             (`core.autotune.model_score`).
* Calibration — `fit_ecm` / `model_residuals` (the effective ECM
             constants of a sweep), `fit_k1` / `k1_residuals` (K1's phase
             costs), `energy` (Fig. 19), and the per-spec artifact
             (`save_calibration` / `load_calibration`).

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
from repro_torch.core.mwd import (barrier_schedule, k1_geometry,
                                  phase_schedule)
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


def super_step_time(t_interior_s: float, t_boundary_s: float,
                    t_exchange_s: float, *, overlap: bool) -> float:
    """Predicted wall time of ONE distributed super-step (Sec. 4.2 analog).

    Both schedules run the same interior/boundary zone split
    (`distributed.stepper.overlap_work`); they differ only in where the
    halo exchange sits:

      synchronous: the exchange comes before any dependent compute, so the
        terms add -> t_exchange + t_interior + t_boundary.

      overlapped: the interior advance runs while the halos travel, and
        only the boundary completion waits for them
        -> max(t_interior, t_exchange) + t_boundary.

    The overlapped win saturates at min(t_interior, t_exchange).
    """
    if overlap:
        return max(t_interior_s, t_exchange_s) + t_boundary_s
    return t_exchange_s + t_interior_s + t_boundary_s


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


def mwd_row_overhead_bytes(spec: StencilSpec, d_w: int, n_f: int,
                           grid_shape,
                           word_bytes: int = DEFAULT_WORD_BYTES) -> float:
    """Extra bytes ONE per-row launch of the reference's schedule moves
    beside the fused one: its two inactive edge tiles, each a whole
    `mwd_tile_bytes` (the reference's Eq. 5-style term, kept for the
    paper's figures; K1's per-row bytes are `k1_predict`'s)."""
    nz, ny, nx = grid_shape
    n_inactive = 2                           # edge columns -1 and ny//D_w + 1
    return n_inactive * mwd_tile_bytes(spec, d_w, n_f, nz, nx, word_bytes)


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
    matrix unit. The collective term is the bytes a device sends over
    every interconnect link at once, one way: ``coll_bytes_per_device /
    (ici_bw_per_link * ici_links / 2)``, since the data sheet's per-link
    rate counts both directions and a device receives as much as it sends
    (the reference prices one link; NVSwitch gives a card all of its
    links). A transfer under the spec's ``latency_bytes`` reports
    "latency".
    """
    chip = chip or devspecs.current_spec()
    return RooflineTerms(
        t_compute=flops_per_device / chip.peak_flops_bf16,
        t_memory=bytes_per_device / chip.hbm_bw,
        t_collective=coll_bytes_per_device / (
            chip.ici_bw_per_link * chip.ici_links / 2),
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        t_latency=chip.launch_s if bytes_per_device > 0 else 0.0,
    )


# ---------------------------------------------------------------------------
# Calibration / validation (paper Sec. 7-8: confront model with measurement)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EcmCalibration:
    """Per-machine effective ECM constants fitted from measured sweep points.

    The a-priori model is parameterized by the declarative device spec; the
    card actually measured realizes different effective throughputs. The
    paper's Sec. 7 validation therefore *fits* the phenomenological
    constants to the sweep — the shape of the model (work terms plus a
    fixed dispatch) is the claim under test, the constants are per-machine:

        t(F, B_hbm) = F / flops_per_s + B_hbm / hbm_bytes_per_s + t_dispatch_s

    An additive combination (no overlap) is the conservative ECM
    composition; on machines that do overlap, the fit absorbs the overlap
    into the effective rates. Rates can be ``math.inf`` when the fit finds
    a term contributes nothing (its coefficient went to zero).
    """

    flops_per_s: float         # effective compute throughput (FLOP/s)
    hbm_bytes_per_s: float     # effective memory throughput (B/s)
    t_dispatch_s: float        # fixed per-launch overhead (s)
    n_points: int              # sweep points the fit consumed
    max_rel_err: float         # worst |pred - meas| / meas over the fit set
    spec: str = ""             # device-spec name the fit was taken under

    def predict_s(self, flops: float, hbm_bytes: float) -> float:
        """Calibrated runtime (s) of a launch doing `flops` and `hbm_bytes`."""
        t = self.t_dispatch_s
        if self.flops_per_s != math.inf:
            t += flops / self.flops_per_s
        if self.hbm_bytes_per_s != math.inf:
            t += hbm_bytes / self.hbm_bytes_per_s
        return t


def _nonneg_lstsq(design, target):
    """Least squares with every coefficient >= 0: a coefficient the
    unconstrained solution drives negative is clamped to zero (its term is
    not observable in the points) and the rest are re-fitted, at most once
    per coefficient."""
    import numpy as np

    n = design.shape[1]
    active = list(range(n))
    coef = np.zeros(n)
    for _ in range(n):
        sol, *_ = np.linalg.lstsq(design[:, active], target, rcond=None)
        coef = np.zeros(n)
        coef[active] = sol
        neg = [i for i in active if coef[i] < 0.0]
        if not neg:
            break
        coef[neg] = 0.0
        active = [i for i in active if i not in neg]
        if not active:
            break
    return [max(float(x), 0.0) for x in coef]


def fit_ecm(points, spec: str | None = None) -> EcmCalibration:
    """Least-squares fit of the ECM constants from measured sweep points.

    `points` is an iterable of ``(flops, hbm_bytes, measured_s)`` triples
    (one per measured launch, e.g. from `repro_torch.launch.sweep`). Solves
    ``t = a*F + b*B + c`` for non-negative ``a, b, c``; a coefficient the
    unconstrained solution drives negative is clamped to zero and the
    remaining terms are re-fitted. Raises ValueError on an empty point
    set; a single point degenerates to a pure-dispatch fit. `spec` names
    the device spec the measurements were taken under (default: the
    process default spec).
    """
    import numpy as np

    pts = [(float(f), float(b), float(t)) for f, b, t in points]
    if not pts:
        raise ValueError("fit_ecm needs at least one (flops, bytes, t) point")
    a, b, c = _nonneg_lstsq(np.array([[f, b, 1.0] for f, b, _ in pts]),
                            np.array([t for _, _, t in pts]))
    calib = EcmCalibration(
        flops_per_s=(1.0 / a) if a > 0.0 else math.inf,
        hbm_bytes_per_s=(1.0 / b) if b > 0.0 else math.inf,
        t_dispatch_s=c,
        n_points=len(pts),
        max_rel_err=0.0,
        spec=spec if spec is not None else devspecs.current_spec().name,
    )
    worst = 0.0
    for f, bb, t in pts:
        if t > 0.0:
            worst = max(worst, abs(calib.predict_s(f, bb) - t) / t)
    return dataclasses.replace(calib, max_rel_err=worst)


def _residual_report(pts, predict, calibration: dict) -> dict:
    per_point, rels = [], []
    for p in pts:
        pred = predict(p)
        meas = float(p["measured_s"])
        rel = (pred - meas) / meas if meas > 0.0 else 0.0
        entry = {"key": p.get("key", ""), "measured_s": meas,
                 "calibrated_s": pred, "rel_err": rel}
        if "model_s" in p:
            entry["model_s"] = float(p["model_s"])
        per_point.append(entry)
        rels.append(rel)
    return {
        "n": len(pts),
        "calibration": calibration,
        "mean_abs_rel_err": (sum(abs(r) for r in rels) / len(rels)
                             if rels else 0.0),
        "max_abs_rel_err": max((abs(r) for r in rels), default=0.0),
        "bias": (sum(rels) / len(rels)) if rels else 0.0,
        "per_point": per_point,
    }


def model_residuals(points, calibration: EcmCalibration | None = None) -> dict:
    """Model-vs-measured residual report over sweep points (Sec. 7 analog).

    `points` is an iterable of dicts with keys ``flops``, ``hbm_bytes``,
    ``measured_s`` and optionally ``key`` (a label) and ``model_s`` (the
    a-priori prediction). When `calibration` is None it is fitted from the
    points themselves (`fit_ecm`).

    Returns ``{"n", "calibration", "mean_abs_rel_err", "max_abs_rel_err",
    "bias", "per_point"}`` where residuals are calibrated-vs-measured
    relative errors ``(pred - meas) / meas``, `bias` is their mean
    (signed), and each per-point entry carries ``{key, measured_s,
    calibrated_s, rel_err[, model_s]}``.
    """
    pts = list(points)
    if calibration is None:
        calibration = fit_ecm(
            (p["flops"], p["hbm_bytes"], p["measured_s"]) for p in pts)
    return _residual_report(
        pts, lambda p: calibration.predict_s(p["flops"], p["hbm_bytes"]),
        dataclasses.asdict(calibration))


# ---------------------------------------------------------------------------
# Energy model (Fig. 19 analog)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyEstimate:
    """Energy split of one run: incremental core + HBM plus static draw."""

    core_j: float
    hbm_j: float
    static_j: float

    @property
    def total_j(self) -> float:
        """Total energy in joules."""
        return self.core_j + self.hbm_j + self.static_j


def energy(flops: float, hbm_bytes: float, runtime_s: float,
           chip: devspecs.DeviceSpec | None = None) -> EnergyEstimate:
    """Fig. 19 energy model: E = P_static*T + e_flop*F + e_byte*B_hbm, with
    the spec's constants (measured on the card by ``chip_smoke.py``)."""
    chip = chip or devspecs.current_spec()
    return EnergyEstimate(
        core_j=chip.joules_per_flop * flops,
        hbm_j=chip.joules_per_hbm_byte * hbm_bytes,
        static_j=chip.static_power_w * runtime_s,
    )


# ---------------------------------------------------------------------------
# Per-spec calibration artifacts
# ---------------------------------------------------------------------------

def calibration_path(results_dir: str, spec_name: str) -> str:
    """Canonical artifact path for a spec's calibration: ``ecm-<spec>.json``."""
    import os
    return os.path.join(results_dir, f"ecm-{spec_name}.json")


def save_calibration(calib: EcmCalibration, results_dir: str) -> str:
    """Persist a fitted calibration as the per-spec artifact; returns path.

    The artifact is keyed by the calibration's recorded spec name so fits
    taken under different machine models never clobber each other.
    """
    import json
    import os
    if not calib.spec:
        raise ValueError("calibration has no spec name; fit with "
                         "fit_ecm(points, spec=...)")
    os.makedirs(results_dir, exist_ok=True)
    path = calibration_path(results_dir, calib.spec)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(calib), f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_calibration(results_dir: str,
                     spec_name: str) -> EcmCalibration | None:
    """Load the persisted calibration for `spec_name`, or None if absent."""
    import json
    import os
    path = calibration_path(results_dir, spec_name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    return EcmCalibration(**raw)


# ---------------------------------------------------------------------------
# K1's shared-memory fit: the twin of choose() and smem_bytes() in mwd.cu
# ---------------------------------------------------------------------------

MWD_SLAB_TARGET = 64    # x columns per CTA the launcher aims for
MWD_MAX_T = 64          # in-tile updates per pass the kernel takes
# per_sm() in mwd.cu: each block's static shared memory (sizeof(Op) of
# stencil_cell.cuh, 2600 bytes at 128 taps and 64 groups) plus 2048 for
# its other tables and the runtime's reserve
MWD_BLOCK_OVERHEAD = 2600 + 2048
# choose() in mwd.cu: the static shared memory of every mwd_row_kernel
# instance as the runtime counts it (cudaFuncGetAttributes), which the
# opt-in limit holds beside the rings: sop (sizeof(Op), 2600), span
# (2 * MWD_MAX_T ints, 512) and xchg (8); `kernel_config` reports it
MWD_STATIC_SMEM = 2600 + 512 + 8


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


def mwd_cluster_slab(nxr: int, cluster: int, word: int) -> tuple[int, int]:
    """``(slab, CTAs)`` of a tile split for `cluster` CTAs over `nxr`
    interior columns: ``choose()``'s rounding in ``csrc/mwd.cu`` (slabs a
    whole 16 bytes; the CTAs that rounding leaves may be fewer)."""
    e = 16 // word                      # elements per 16 bytes
    slab = max(-(-nxr // cluster) + e - 1, e) // e * e
    return slab, max(1, -(-nxr // slab))


def mwd_smem_plan(op: StencilSpec, d_w: int, n_f: int, nx: int,
                  word: int = DEFAULT_WORD_BYTES,
                  chip: devspecs.DeviceSpec | None = None,
                  cluster: int | None = None) -> SmemPlan | None:
    """K1's slab, cluster, staging and shared memory for grids `nx` wide.

    The Python twin of ``choose()`` and ``smem_bytes()`` in
    ``csrc/mwd.cu``, at the default interior (x width ``nx - 2R``). None
    where the kernel refuses with E_SMEM (no cluster of at most
    ``chip.max_cluster`` CTAs holds the rings beside the block's static
    shared memory, `MWD_STATIC_SMEM`) or where the plan is not a
    K1 plan (2R or n_f not dividing d_w, more than `MWD_MAX_T` updates a
    pass). `cluster` (``prepare(cluster=)``) tries that size alone: None
    also where its slab rounding gives another count of CTAs or slabs
    narrower than R (E_CLUSTER_SIZE), or where its rings do not fit.
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
    sizes = (range(max(1, -(-nxr // MWD_SLAB_TARGET)), chip.max_cluster + 1)
             if cluster is None else (cluster,))
    for c in sizes:
        slab, cl = mwd_cluster_slab(nxr, c, word)
        if cluster is not None and (cl != c or (cl > 1 and slab < r)):
            return None
        if cl > chip.max_cluster or (cl > 1 and slab < r):
            break
        plain = smem(slab, False)
        staged = smem(slab, True) if n_arr else -1
        limit = chip.smem_block_bytes - MWD_STATIC_SMEM
        stage = 0 <= staged <= limit and per_sm(staged) >= per_sm(plain)
        b = staged if stage else plain
        if b > limit:
            continue
        return SmemPlan(cluster=cl, slab=slab, stage=int(stage),
                        threads=256 if per_sm(b) >= 2 else 512,
                        smem_bytes=b, per_sm=per_sm(b), depth=depth,
                        cdepth=cdepth)
    return None


def smem_fits(op: StencilSpec, d_w: int, n_f: int, nx: int,
              word: int = DEFAULT_WORD_BYTES,
              chip: devspecs.DeviceSpec | None = None,
              cluster: int | None = None) -> bool:
    """Whether K1 launches the plan on grids `nx` wide: `mwd_smem_plan`
    finds rings that fit and at least one such CTA fits an SM by the
    kernel's own count (where it counts none, the occupancy API decides
    and may refuse the launch)."""
    plan = mwd_smem_plan(op, d_w, n_f, nx, word, chip, cluster)
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


# K1's measured costs (the spec's fields), one per kind of phase work
# `phase_schedule` counts: a phase ended by a cluster barrier, a phase
# ended by a block barrier, and the loads of the rows a phase's busiest
# warp updates (a row of cells reads every tap and every coefficient stream)
K1_COSTS = {"cluster": "k1_phase_s", "cta": "k1_cta_phase_s",
            "row_loads": "k1_row_load_s"}
MWD_CELLS = 2           # cells per lane and row in mwd.cu (32 columns apart)


@dataclasses.dataclass(frozen=True)
class K1Prediction:
    """The K1 model's terms for one advance (seconds, and what they count).

    `t_total` is ``max(t_bytes, t_flops) + t_phase + t_launch``: bytes and
    flops overlap, the barrier-ended phases of the wavefront are the chain
    every CTA walks, and the rows run one launch after another. `phases`
    holds the counts the phase term prices (`K1_COSTS`), each on the
    critical path: per row, the most any CTA of the row passes, times the
    waves of resident clusters.
    """

    t_bytes: float
    t_flops: float
    t_phase: float
    t_launch: float
    hbm_bytes: float
    flops: float
    phases: dict           # {"cluster", "cta", "row_loads"}, critical path
    launches: int
    lups: float
    smem: SmemPlan | None

    @property
    def t_fixed(self) -> float:
        """The terms the phase costs are fitted beside (`fit_k1`)."""
        return max(self.t_bytes, self.t_flops) + self.t_launch

    @property
    def t_total(self) -> float:
        """Predicted time of the advance."""
        return self.t_fixed + self.t_phase

    @property
    def dominant(self) -> str:
        """The largest term: "bytes", "flops", "phase" or "launch"."""
        terms = {"bytes": self.t_bytes, "flops": self.t_flops,
                 "phase": self.t_phase, "launch": self.t_launch}
        return max(terms, key=terms.get)


# registers per thread of each mwd_row_kernel instance, by (word size,
# coefficients staged, hoisted coefficient groups): ptxas -v of csrc/mwd.cu
# for sm_90a, which chip_smoke.py phase 1 prints and checks for f32 and f64
# (the 2-byte words take the most of their four instances)
MWD_REGISTERS = {(4, 0, 0): 64, (4, 0, 8): 64, (4, 0, 16): 112,
                 (4, 1, 0): 64, (4, 1, 8): 116, (4, 1, 16): 128,
                 (8, 0, 0): 64, (8, 0, 8): 128, (8, 0, 16): 128,
                 (8, 1, 0): 64, (8, 1, 8): 128, (8, 1, 16): 128,
                 (2, 0, 0): 64, (2, 0, 8): 64, (2, 0, 16): 128,
                 (2, 1, 0): 64, (2, 1, 8): 118, (2, 1, 16): 128}


def mwd_hoist(op: StencilSpec) -> int:
    """Hoisted coefficient groups of K1's instance for `op` (plan_launch in
    mwd.cu: the fewest of 0, 8 or 16 that cover its array groups)."""
    n = sum(coeff.kind == "array" for coeff, _ in op.groups)
    return 0 if n == 0 else 8 if n <= 8 else 16


def k1_resident(op: StencilSpec, smem: SmemPlan, exchange: bool,
                word: int = DEFAULT_WORD_BYTES,
                chip: devspecs.DeviceSpec | None = None) -> int:
    """Clusters (single CTAs without halo exchange) the card holds at once.

    CTAs per SM: the fewest that shared memory (`SmemPlan.per_sm`), the
    SM's threads and its registers (`MWD_REGISTERS`) allow. A cluster keeps
    to one GPC: each of the spec's ``n_gpc`` holds ``n_sm // n_gpc`` SMs'
    worth of CTAs, so large clusters fit fewer than the SM count says.
    """
    chip = chip or devspecs.current_spec()
    regs = MWD_REGISTERS.get((word, smem.stage, mwd_hoist(op)), 128)
    per_sm = min(smem.per_sm, chip.threads_sm // smem.threads,
                 chip.regs_sm // (smem.threads * regs))
    if not exchange:
        return max(1, chip.n_sm * per_sm)
    per_gpc = (chip.n_sm // chip.n_gpc) * per_sm // smem.cluster
    return max(1, chip.n_gpc * per_gpc)


def k1_waves(resident: int, exchange: bool, tiles: int,
             smem: SmemPlan) -> int:
    """Waves one row of `tiles` tiles takes with `resident` clusters (or
    single CTAs, without halo exchange: a tile's `cluster` CTAs) at once
    (`k1_resident`)."""
    units = tiles if exchange else tiles * smem.cluster
    return -(-units // resident)


def k1_phase_cost(phases: dict, chip: devspecs.DeviceSpec) -> float:
    """Seconds of K1's phase term: each count times its measured cost."""
    return sum(phases[k] * getattr(chip, f) for k, f in K1_COSTS.items())


def k1_predict(op: StencilSpec, grid_shape, d_w: int, n_f: int,
               n_steps: int, *, fused: bool = True,
               word: int = DEFAULT_WORD_BYTES,
               chip: devspecs.DeviceSpec | None = None,
               cluster: int | None = None) -> K1Prediction:
    """K1's time for one `ops.mwd` advance of one grid, term by term.

    Bytes: `mwd_schedule_bytes`; the per-row mode also copies both padded
    grids before every row and runs every tile, the inactive ones too.
    Flops: ``flops_per_lup * LUPs`` over the f32 peak. Phases: per row, the
    most barrier-ended phases any CTA passes (`core.mwd.phase_schedule`:
    ended by a cluster barrier, by a block barrier, and the rows of
    updates on each phase's busiest warp times the loads of a row's cells,
    one per tap and coefficient stream), times the waves of resident
    clusters (`k1_resident`, `k1_waves`), each priced at the spec's
    measured cost
    (`K1_COSTS`, fitted by `fit_k1`). Launches: one per diamond row, times
    ``chip.launch_s``. `cluster` prices K1 at that many CTAs a tile
    (`mwd_smem_plan`). Raises ValueError where `mwd_smem_plan` finds no
    fit; the host side of `ops.mwd` (padding, cropping) is not modeled.
    """
    chip = chip or devspecs.current_spec()
    nz, ny, nx = grid_shape
    smem = mwd_smem_plan(op, d_w, n_f, nx, word, chip, cluster)
    if smem is None:
        raise ValueError(f"{op.name}: no K1 launch fits d_w={d_w}, "
                         f"n_f={n_f} at nx={nx}, word={word}"
                         + (f", cluster={cluster}" if cluster else ""))
    geo = k1_geometry(op.radius, grid_shape, d_w, n_f, n_steps, fused=fused)
    comp = geo.comp
    lups = float(nz * ny * nx * n_steps)
    flops = op.flops_per_lup * lups
    n_rows = comp.n_rows
    hbm = mwd_schedule_bytes(op, grid_shape, d_w, n_rows, word)
    phases = {k: 0 for k in K1_COSTS}
    if n_rows:
        cells = -(-smem.slab // (32 * MWD_CELLS))
        cluster, cta, rows = phase_schedule(geo, smem.threads // 32, cells)
        counts = {"cluster": cluster, "cta": cta,
                  "row_loads": rows * (len(op.taps) + op.n_coeff_arrays)}
        exchange = bool(barrier_schedule(geo)[0].any())
        resident = k1_resident(op, smem, exchange, word, chip)
        for i in range(n_rows):
            tiles = int(comp.active[i].sum()) if fused else comp.n_tiles
            waves = k1_waves(resident, exchange, tiles, smem)
            for k, c in counts.items():
                phases[k] += waves * int(c[i].max())
        if not fused:
            hbm *= comp.n_rows * comp.n_tiles / max(comp.n_active, 1)
            padded = ((geo.n_j * n_f) * (ny + 2 * geo.pads[1])
                      * (nx + 2 * geo.pads[2]))
            hbm += n_rows * 2 * 2 * padded * word     # clones, read + write
    return K1Prediction(
        t_bytes=hbm / chip.hbm_bw, t_flops=flops / chip.peak_flops_f32,
        t_phase=k1_phase_cost(phases, chip),
        t_launch=n_rows * chip.launch_s, hbm_bytes=hbm, flops=flops,
        phases=phases, launches=n_rows, lups=lups, smem=smem)


@dataclasses.dataclass(frozen=True)
class K1Calibration:
    """K1's phase costs fitted from measured K1 times (`fit_k1`).

    `costs_s` maps each spec field of `K1_COSTS` to its fitted seconds (0
    where the points cannot see the term: the clamp of `fit_ecm`);
    `max_rel_err` is the worst |predicted - measured| / measured over the
    fit set.
    """

    costs_s: dict
    n_points: int
    max_rel_err: float

    def predict_s(self, point: dict) -> float:
        """K1 seconds of a `k1_fit_point` under these costs."""
        return point["fixed_s"] + sum(
            point["phases"][k] * self.costs_s[f] for k, f in K1_COSTS.items())


def k1_fit_point(key: str, terms, measured_s: float | None = None) -> dict:
    """One `fit_k1` input from a K1 model's terms: a `K1Prediction`, or the
    ``model.k1`` record of a sweep point (`launch.sweep.k1_terms`)."""
    if isinstance(terms, K1Prediction):
        fixed, phases, model = terms.t_fixed, terms.phases, terms.t_total
    else:
        fixed = terms["t_s"] - terms["t_phase"]
        phases, model = terms["phases"], terms["t_s"]
    return {"key": key, "fixed_s": fixed, "phases": dict(phases),
            "model_s": model, "measured_s": measured_s}


def fit_k1(points) -> K1Calibration:
    """Least-squares fit of K1's phase costs from measured K1 times.

    `points` are `k1_fit_point` dicts: the model's fixed terms (bytes or
    flops, and launches), the phase counts times waves on the critical
    path, and K1's measured seconds (CUDA events). Solves ``measured -
    fixed = sum(cost_k * phases_k)`` for non-negative costs, clamping and
    re-fitting as `fit_ecm` does. Raises ValueError on an empty set.
    """
    import numpy as np

    pts = list(points)
    if not pts:
        raise ValueError("fit_k1 needs at least one measured point")
    design = np.array([[float(p["phases"][k]) for k in K1_COSTS]
                       for p in pts])
    target = np.array([float(p["measured_s"]) - p["fixed_s"] for p in pts])
    coef = _nonneg_lstsq(design, target)
    calib = K1Calibration(costs_s=dict(zip(K1_COSTS.values(), coef)),
                          n_points=len(pts), max_rel_err=0.0)
    worst = max((abs(calib.predict_s(p) - p["measured_s"]) / p["measured_s"]
                 for p in pts if p["measured_s"] > 0), default=0.0)
    return dataclasses.replace(calib, max_rel_err=worst)


def k1_residuals(points, calibration: K1Calibration | None = None) -> dict:
    """`model_residuals` for K1's phase model: fitted (or given) costs
    against the measured K1 times, each point beside the spec's own
    prediction (``model_s``)."""
    pts = list(points)
    if calibration is None:
        calibration = fit_k1(pts)
    return _residual_report(pts, calibration.predict_s,
                            dataclasses.asdict(calibration))


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
