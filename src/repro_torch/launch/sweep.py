"""Grid-size sweep harness: the paper's Sec. 7-8 performance study as a CLI.

The port of `repro.launch.sweep`. For every point of a (stencil x grid x
execution mode x batch size) lattice it

* resolves the MWD plan registry-first (``plan="auto"`` semantics; pass
  ``--tune measured`` to run the measured auto-tuner per point first,
  warming the port's plan registry in bulk),
* times the whole `ops.mwd` (or `ops.mwd_batched`) call with the timing
  primitive the measured auto-tuner uses (`core.autotune.time_mwd_launch`)
  and, on the card, K1 alone by CUDA events on a prepared job,
* records K1's HBM traffic (`core.traffic`, B/LUP), the a-priori ECM
  prediction from the device spec (with ``t_smem`` where the reference has
  ``t_vmem``), the K1 time model's terms (`models.k1_predict`) and the
  Fig. 19 energy split (`models.energy`), and the card's name and power
  limit, and
* appends the point to a versioned JSON file under
  ``src/repro_torch/results/`` (never the reference's ``results/``).

Sweeps are resumable: a point whose key already exists in any
``sweep*.json`` beside the target file, measured under the current hardware
fingerprint, is skipped, so an interrupted sweep continues where it stopped
and a finished sweep re-run measures nothing (``--expect-cached`` turns that
into a hard exit code). A finished run fits the ECM calibration over every
point in the file and saves it as ``ecm-<spec>.json`` beside it.

The distributed leg (``--distributed``) adds a deep-halo super-stepper
point per (stencil, grid): `distributed.stepper` with K1 per shard on a
mesh of ``--shards`` shards (default: one per local card), the plan
resolved against the per-shard extended block. The scaling lattice
(``--scaling``, into ``sweep-scaling.json``) times overlapped against
synchronous super-steps of the plain route over the 1-2-4-8 shard ladder,
each pair in one interleaved session; `launch.scaling_gate` reads it. On a
machine with fewer cards than shards the shards share cards (round robin),
and the ladder then measures the cost of the decomposition (copies, halo
redundancy, more launches), not scaling.

Render the study with ``python -m repro_torch.launch.report``.

  python -m repro_torch.launch.sweep --sizes 128,256,384,512,640,768 \\
      --steps 8 --tune measured                       # on the card
  python -m repro_torch.launch.sweep --device cpu --sizes 8,12 \\
      --results /tmp/sweep.json                       # CPU, tiny grids
  python -m repro_torch.launch.sweep --sizes 512 --steps 8 \\
      --distributed --shards 4                        # 2x2 shards
  python -m repro_torch.launch.sweep --scaling        # the shard ladder

Output: one ``key,cached|measured,t_s,glups,b_per_lup,model_glups`` row per
point plus a summary line (points measured / skipped / total seconds).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob as _glob
import json
import os
import subprocess
import tempfile
import time

from repro_torch.core import autotune, ir, models, precision
from repro_torch.core import registry as reg
from repro_torch.core import specs as devspecs
from repro_torch.core import stencils as st
from repro_torch.core import traffic
from repro_torch.core.mwd import MWDPlan

SCHEMA_VERSION = 1
RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "results")
DEFAULT_RESULTS = os.path.join(RESULTS_DIR, "sweep.json")
SCALING_RESULTS = os.path.join(RESULTS_DIR, "sweep-scaling.json")
# the smoke sweep writes beside, not into, the committed results directory,
# so its CPU points never enter the report or the calibration
SMOKE_RESULTS = os.path.join(RESULTS_DIR, "smoke", "sweep-smoke.json")

# the reference's CI-scale smoke ladder, keyed by stencil radius: the
# radius-4 (25-point) operators need y room for a D_w = 2R = 8 diamond
SMOKE_SIZES = {1: (8, 12), 4: (16, 20)}

def point_key(spec: st.StencilSpec, grid_shape, n_steps: int, fused: bool,
              batch: int, word_bytes: int = 4, dtype_name: str = "f32",
              distributed: bool = False, n_devices: int | None = None,
              overlap: bool = False, scaling: str | None = None) -> str:
    """Stable identity of one sweep point (resume skips existing keys).

    The reference's key: the operator's structural IR fingerprint, the
    grid, the step count, the execution mode, the batch size and the word
    size; ``|dist`` for the distributed leg, extended for a scaling leg by
    its shard count, schedule and regime (``|dist|d4|ovl|strong``); a
    non-f32 stream dtype appended (``|bf16``). The hardware fingerprint is
    NOT part of the key: it is stored on the point, and resume treats a
    mismatch as a miss.
    """
    nz, ny, nx = grid_shape
    key = (f"{spec.name}@{spec.fingerprint}|{nz}x{ny}x{nx}|s{n_steps}"
           f"|{'fused' if fused else 'row'}|b{batch}|w{word_bytes}")
    if distributed:
        key += "|dist"
        if n_devices is not None:
            key += f"|d{n_devices}"
        if overlap:
            key += "|ovl"
        if scaling:
            key += f"|{scaling}"
    if dtype_name != "f32":
        key += f"|{dtype_name}"
    return key


def ladder(sizes) -> list[tuple[int, int, int]]:
    """Paper-style N^3 grid ladder: one cubic grid per requested size."""
    return [(int(n),) * 3 for n in sizes]


@dataclasses.dataclass(frozen=True)
class PointSpec:
    """One cell of the sweep lattice, before any measurement.

    `distributed` marks the deep-halo super-stepper leg; `n_devices`,
    `overlap` and `scaling` describe a scaling leg: its pinned shard
    count, its super-step schedule, and its ladder, strong (fixed global
    grid) or weak (fixed per-shard grid).
    """

    spec: st.StencilSpec
    grid: tuple[int, int, int]
    n_steps: int
    fused: bool
    batch: int
    word_bytes: int
    dtype_name: str = "f32"
    distributed: bool = False
    n_devices: int | None = None
    overlap: bool = False
    scaling: str | None = None

    @property
    def key(self) -> str:
        """The point's identity under `point_key`."""
        return point_key(self.spec, self.grid, self.n_steps, self.fused,
                         self.batch, self.word_bytes, self.dtype_name,
                         self.distributed, self.n_devices, self.overlap,
                         self.scaling)


def k1_terms(spec: st.StencilSpec, grid, n_steps: int, plan: MWDPlan,
             batch: int, word_bytes: int,
             chip: devspecs.DeviceSpec | None = None) -> dict:
    """The K1 time model's terms for one point (`models.k1_predict`): what
    `models.fit_k1` reads (phases times waves, launches, the fixed terms)
    and the predicted seconds, batch-amortized as `model_score` does."""
    chip = chip or devspecs.current_spec()
    pred = models.k1_predict(spec, grid, plan.d_w, plan.n_f, n_steps,
                             fused=plan.fused, word=word_bytes, chip=chip)
    t = models.batch_amortized_time(pred.t_total - pred.t_launch, batch,
                                    pred.t_launch)
    return {"t_s": t, "glups": pred.lups * batch / t / 1e9,
            "t_bytes": pred.t_bytes, "t_flops": pred.t_flops,
            "t_phase": pred.t_phase, "t_launch": pred.t_launch,
            "phases": dict(pred.phases), "launches": pred.launches,
            "dominant": pred.dominant}


def model_point(spec: st.StencilSpec, grid, n_steps: int, plan: MWDPlan,
                batch: int, word_bytes: int,
                chip: devspecs.DeviceSpec | None = None) -> dict:
    """Model-side columns of one sweep point (no measurement).

    K1's traffic (`core.traffic.mwd_run_traffic`), the Eq. 5 idealized
    code balance, the ECM time/throughput prediction at K1's B/LUP
    (batch-amortized for B > 1) with the per-term breakdown and the binding
    term named (``ecm.dominant``: "latency" under the spec's
    ``latency_bytes`` crossover), the K1 model's terms (`k1_terms`) and the
    Fig. 19 energy split at the ECM runtime. `chip=None` resolves the
    process default spec.
    """
    import numpy as np

    chip = chip or devspecs.current_spec()
    lups_item = float(np.prod(grid)) * n_steps
    lups = lups_item * batch
    tr = traffic.mwd_run_traffic(spec, grid, n_steps, plan.d_w, plan.n_f,
                                 word_bytes, fused=plan.fused)
    hbm_bytes = tr["bytes"] * batch          # each grid streams its windows
    flops = spec.flops_per_lup * lups
    pred = models.ecm_predict(spec, tr["code_balance"], lups_item, chip,
                              word_bytes)
    t_model = models.batch_amortized_time(pred.t_total, batch)
    energy = models.energy(flops, hbm_bytes, t_model, chip)
    return {
        "lups": lups,
        "flops": flops,
        "traffic": {
            "hbm_bytes": hbm_bytes,
            "b_per_lup": tr["code_balance"],
            "launches": tr["launches"],
        },
        "model": {
            "bc_eq5": models.code_balance(spec, plan.d_w, word_bytes),
            "bc_spatial": models.spatial_code_balance(spec, word_bytes),
            "t_s": t_model,
            "glups": lups / t_model / 1e9,
            "ecm": {
                "t_compute": pred.t_compute,
                "t_smem": pred.t_smem,
                "t_hbm": pred.t_hbm,
                "t_latency": pred.t_latency,
                "dominant": pred.dominant,
                "latency_bytes": chip.latency_bytes,
            },
            "k1": k1_terms(spec, grid, n_steps, plan, batch, word_bytes,
                           chip),
            "energy_j": {
                "core": energy.core_j,
                "hbm": energy.hbm_j,
                "static": energy.static_j,
                "total": energy.total_j,
            },
        },
    }


def k1_event_s(spec: st.StencilSpec, state, coeffs, n_steps: int,
               plan: MWDPlan, *, reps: int = 2, warmup: int = 1) -> float:
    """Median seconds of K1 alone by CUDA events: one prepared job of
    `plan`, its grids restored untimed before every run, so the host side
    of `ops.mwd` (frame, padding, crop) is not in the time."""
    import statistics

    import torch

    from repro_torch.kernels import stencil_mwd as sm

    arrays, scalars = ir.split_coeffs(spec, coeffs)
    job = sm.prepare(spec, state, arrays, scalars, n_steps, d_w=plan.d_w,
                     n_f=plan.n_f, fused=plan.fused)
    if job.bufs is None:
        return 0.0
    saved = [b.clone() for b in job.bufs]
    times = []
    for i in range(warmup + reps):
        for b, s in zip(job.bufs, saved):
            b.copy_(s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sm.run_kernel(job)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def measure_point(ps: PointSpec, plan: MWDPlan, *, reps: int = 2,
                  warmup: int = 1, seed: int = 0,
                  device: str = "cuda") -> dict:
    """Time one sweep point: the median seconds and GLUP/s of the whole
    call and, for one problem on the card, K1's own seconds (`k1_t_s`).
    The problems are `random_problem`'s (`make_problem`'s distribution
    drawn on the device: the reference's host draws take minutes a point
    at 768^3)."""
    import numpy as np

    dt = precision.parse_dtype(ps.dtype_name)
    probs = [st.random_problem(ps.spec, ps.grid, dtype=dt, seed=seed + i,
                               device=device)
             for i in range(ps.batch)]
    t = autotune.time_mwd_launch(
        ps.spec, [p[0] for p in probs], [p[1] for p in probs], ps.n_steps,
        plan, reps=reps, warmup=warmup)
    lups = float(np.prod(ps.grid)) * ps.n_steps * ps.batch
    out = {"t_s": t, "glups": lups / t / 1e9}
    if ps.batch == 1 and probs[0][0][0].is_cuda:
        out["k1_t_s"] = k1_event_s(ps.spec, probs[0][0], probs[0][1],
                                   ps.n_steps, plan, reps=reps,
                                   warmup=warmup)
    return out


def _distributed_model(ps: PointSpec, plan: MWDPlan, measured: dict) -> dict:
    """Model columns of a distributed point, coherent with its measurement.

    The measured side is the whole run on the global grid (``n_super``
    super-steps, every shard); the model side describes the same run:
    flops and HBM bytes summed over every shard's extended block and every
    super-step (the halo redundancy is real work), the model time
    ``n_super`` super-steps of one shard's K1 advance (shards on separate
    cards run concurrently), useful LUPs the global grid's.
    """
    import numpy as np

    shape_e = tuple(measured["local_extended_shape"])
    n_super, n_dev = measured["n_super_steps"], measured["n_devices"]
    per_super = model_point(ps.spec, shape_e, measured["t_block"], plan, 1,
                            ps.word_bytes)
    lups = float(np.prod(ps.grid)) * n_super * measured["t_block"]
    flops = per_super["flops"] * n_super * n_dev
    hbm_bytes = per_super["traffic"]["hbm_bytes"] * n_super * n_dev
    t_model = per_super["model"]["t_s"] * n_super
    energy = models.energy(flops, hbm_bytes, t_model)
    return {
        "lups": lups,
        "flops": flops,
        "traffic": {"hbm_bytes": hbm_bytes,
                    "b_per_lup": hbm_bytes / lups,
                    "launches": per_super["traffic"]["launches"] * n_super},
        "model": {
            "bc_eq5": per_super["model"]["bc_eq5"],
            "bc_spatial": per_super["model"]["bc_spatial"],
            "t_s": t_model,
            "glups": lups / t_model / 1e9,
            "energy_j": {"core": energy.core_j, "hbm": energy.hbm_j,
                         "static": energy.static_j,
                         "total": energy.total_j},
        },
    }


def _scaling_model(ps: PointSpec, measured: dict) -> dict:
    """Model columns of a plain-route scaling leg, coherent with its
    schedule: interior + boundary cells per shard per super-step
    (`stepper.overlap_work`; both schedules sweep the same cells), each
    streaming the op's reads and one write through HBM, priced at the
    device spec's roofline."""
    import numpy as np

    w = measured["overlap_work"]
    n_super, n_dev = measured["n_super_steps"], measured["n_devices"]
    cells_dev = w["interior_cells"] + w["boundary_cells"]
    lups = float(np.prod(ps.grid)) * n_super * measured["t_block"]
    flops = ps.spec.flops_per_lup * cells_dev * n_super * n_dev
    hbm_bytes = ((ps.spec.n_streams + 1) * ps.word_bytes
                 * cells_dev * n_super * n_dev)
    chip = devspecs.current_spec()
    t_model = n_super * max(
        ps.spec.flops_per_lup * cells_dev / chip.peak_flops_f32,
        (ps.spec.n_streams + 1) * ps.word_bytes * cells_dev / chip.hbm_bw)
    energy = models.energy(flops, hbm_bytes, t_model)
    return {
        "lups": lups,
        "flops": flops,
        "traffic": {"hbm_bytes": hbm_bytes,
                    "b_per_lup": hbm_bytes / lups,
                    "launches": n_super},
        "model": {
            "bc_eq5": models.spatial_code_balance(ps.spec, ps.word_bytes),
            "bc_spatial": models.spatial_code_balance(ps.spec,
                                                      ps.word_bytes),
            "t_s": t_model,
            "glups": lups / t_model / 1e9,
            "energy_j": {"core": energy.core_j, "hbm": energy.hbm_j,
                         "static": energy.static_j,
                         "total": energy.total_j},
        },
    }


def measure_distributed_point(ps: PointSpec, registry: reg.PlanRegistry, *,
                              t_block: int = 2, reps: int = 2,
                              warmup: int = 1, seed: int = 0,
                              device: str = "cuda", shards: int | None = None
                              ) -> tuple[dict, MWDPlan | None, str]:
    """Time the deep-halo super-stepper leg of one (stencil, grid) point.

    Builds the mesh (`distributed.elastic.build_mesh` over
    ``ps.n_devices``, else `shards`, else one shard per local card; the
    shards share cards round robin where there are fewer), extends the
    coefficients once outside the timed loop (as `run_distributed` does)
    and times ``ceil(n_steps / t_block)`` super-steps back to back under
    `autotune.time_callable`, the clock stopped when the card is done.

    A distributed point resolves its K1 plan from `registry` against the
    per-shard extended block; a scaling leg (``ps.scaling``) runs the
    plain route, records the swept-cell split (`stepper.overlap_work`) and
    the halo bytes per super-step, and times an overlapped leg together
    with its synchronous twin in one interleaved session
    (`autotune.time_callable_paired`). Returns ``(measured, plan,
    source)``; plan is None on the plain route.
    """
    import numpy as np

    from repro_torch.distributed import elastic, halo, stepper
    from repro_torch.launch import mesh as launch_mesh

    n = ps.n_devices or shards or len(launch_mesh.local_devices(device))
    mesh = elastic.build_mesh(n, launch_mesh.device_pool(n, device))
    if ps.scaling:
        # the gate compares overlap/sync pairs: more samples, a second
        # warm-up, and the min of the reps
        reps, warmup = max(reps, 7), max(warmup, 2)
    stepper.validate_super_step(ps.spec, mesh, ps.grid, t_block,
                                overlap=ps.overlap)
    gs = stepper.GridSharding(mesh)
    home = gs.devices()[0][0]
    (cur, prev), coeffs = st.random_problem(
        ps.spec, ps.grid, dtype=precision.parse_dtype(ps.dtype_name),
        seed=seed, device=home)
    shape_e = stepper.local_extended_shape(ps.spec, mesh, ps.grid, t_block)
    if ps.scaling:
        plan, source = None, "none-plain"
    else:
        plan, source = stepper.resolve_shard_plan(
            ps.spec, mesh, ps.grid, t_block, word_bytes=cur.element_size(),
            registry=registry)
    cur_g = gs.shard(cur)
    prev_g = gs.shard(prev) if ps.spec.time_order == 2 else cur_g
    arrays, scalars = stepper.canonical_coeffs(ps.spec, coeffs)
    # the one coefficient exchange stays OUTSIDE the timed loop
    coeffs_h = stepper.make_coeff_extender(ps.spec, t_block)(
        (gs.shard(arrays) if arrays is not None else None, scalars))
    n_super = -(-ps.n_steps // t_block)
    sync = autotune.device_sync(cur)

    def make_launch(overlap):
        step = stepper.make_super_step(ps.spec, mesh, ps.grid, t_block,
                                       plan=plan, overlap=overlap)

        def launch():
            a, b = cur_g, prev_g
            for _ in range(n_super):
                a, b = step(a, b, coeffs_h)
        return launch

    paired_sync_t = None
    if ps.scaling and ps.overlap:
        t, paired_sync_t = autotune.time_callable_paired(
            make_launch(True), make_launch(False), reps=reps, warmup=warmup,
            sync=sync)
    else:
        t = autotune.time_callable(make_launch(ps.overlap), reps=reps,
                                   warmup=warmup, sync=sync,
                                   stat="min" if ps.scaling else "median")
    lups = float(np.prod(ps.grid)) * n_super * t_block
    n_z, n_y = gs.counts()
    local_shape = (ps.grid[0] // n_z, ps.grid[1] // n_y, ps.grid[2])
    g = ps.spec.radius * t_block
    measured = {"t_s": t, "glups": lups / t / 1e9,
                "n_devices": int(mesh.devices.size), "t_block": t_block,
                "n_super_steps": n_super,
                "local_extended_shape": list(shape_e),
                "overlap": ps.overlap,
                "overlap_work": stepper.overlap_work(
                    local_shape, ps.spec.radius, t_block,
                    split_z=n_z > 1, split_y=n_y > 1),
                "halo_bytes": halo.halo_bytes(
                    local_shape, g, cur.element_size(),
                    2 if ps.spec.time_order == 2 else 1),
                "cards": len({str(d) for d in mesh.devices.flat})}
    if ps.scaling:
        measured["scaling"] = ps.scaling
    if paired_sync_t is not None:
        measured["paired_sync_t_s"] = paired_sync_t
    return measured, plan, source


@functools.lru_cache(maxsize=None)
def device_record(device: str) -> dict:
    """The card a point ran on: its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` reports them (``cpu`` on the CPU)."""
    if device == "cpu":
        return {"name": "cpu", "power_limit": None}
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    limit = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit}


# ---------------------------------------------------------------------------
# Results files: versioned JSON, atomic writes, resume
# ---------------------------------------------------------------------------

def load_results(path: str) -> dict:
    """Load one results file; corrupt/missing/mismatched reads as empty."""
    try:
        with open(path) as f:
            raw = json.load(f)
        if raw.get("version") != SCHEMA_VERSION:
            return {"version": SCHEMA_VERSION, "points": {}}
        raw.setdefault("points", {})
        return raw
    except (OSError, ValueError):
        return {"version": SCHEMA_VERSION, "points": {}}


def save_results(path: str, results: dict) -> None:
    """Atomically persist a results file (tmp + rename, like the registry)."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(results, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def done_keys(results_path: str) -> dict[str, str]:
    """Map of point key -> hw fingerprint over every sweep file in the dir.

    Resume consults every ``sweep*.json`` sibling of the target file, not
    just the target: a point measured by an earlier differently-named
    sweep run is still done.
    """
    out: dict[str, str] = {}
    pattern = os.path.join(os.path.dirname(results_path) or ".",
                           "sweep*.json")
    for path in sorted(_glob.glob(pattern)):
        for key, point in load_results(path)["points"].items():
            out[key] = point.get("hw_fingerprint", "")
    return out


# ---------------------------------------------------------------------------
# The sweep loop
# ---------------------------------------------------------------------------

def iter_points(specs, grids, modes, batches, n_steps: int, word_bytes: int,
                dtype_name: str = "f32",
                distributed: bool = False) -> list[PointSpec]:
    """Deterministic sweep lattice: stencil-major, then grid, mode, batch,
    then the (stencil, grid)'s distributed point."""
    points = []
    for spec in specs:
        for grid in grids:
            points += [PointSpec(spec, tuple(grid), n_steps, mode == "fused",
                                 batch, word_bytes, dtype_name=dtype_name)
                       for mode in modes for batch in batches]
            if distributed:
                points.append(PointSpec(spec, tuple(grid), n_steps, True, 1,
                                        word_bytes, dtype_name=dtype_name,
                                        distributed=True))
    return points


def run_point(ps: PointSpec, registry: reg.PlanRegistry, *, reps: int,
              warmup: int, tune: str = "none", tune_max_evals: int = 12,
              seed: int = 0, device: str = "cuda",
              shards: int | None = None) -> dict:
    """Measure one sweep point end to end and return the recorded dict.

    Plan resolution is registry-first (``plan="auto"`` semantics). With
    ``tune="measured"`` / ``tune="model"`` a single-device point first runs
    the measured / model-scored auto-tuner through `launch.tune.tune_one`
    (at the point's step count and dtype, on `device`), persisting the
    winner. A distributed point goes to `measure_distributed_point`.
    """
    from repro_torch.launch import tune as tune_cli

    if ps.distributed:
        measured, plan, plan_source = measure_distributed_point(
            ps, registry, reps=reps, warmup=warmup, seed=seed,
            device=device, shards=shards)
        modeled = (_scaling_model(ps, measured) if ps.scaling
                   else _distributed_model(ps, plan, measured))
    elif tune != "none":
        rep = tune_cli.tune_one(ps.spec, ps.grid, registry,
                                word_bytes=ps.word_bytes,
                                measured=tune == "measured",
                                max_evals=tune_max_evals, batch=ps.batch,
                                n_steps=ps.n_steps, dtype=ps.dtype_name,
                                device=device)
        plan, plan_source = rep["plan"], f"tuned:{rep['source']}"
    else:
        plan, plan_source = registry.resolve(
            ps.spec, ps.grid, word_bytes=ps.word_bytes, batch=ps.batch)
    if not ps.distributed:
        plan = dataclasses.replace(plan, fused=ps.fused)
        modeled = model_point(ps.spec, ps.grid, ps.n_steps, plan, ps.batch,
                              ps.word_bytes)
        measured = measure_point(ps, plan, reps=reps, warmup=warmup,
                                 seed=seed, device=device)
    point = {
        "key": ps.key,
        "stencil": ps.spec.name,
        "op_fingerprint": ps.spec.fingerprint,
        "grid": list(ps.grid),
        "n_steps": ps.n_steps,
        "mode": "fused" if ps.fused else "row",
        "batch": ps.batch,
        "word_bytes": ps.word_bytes,
        "dtype": ps.dtype_name,
        "distributed": ps.distributed,
        "plan": dataclasses.asdict(plan) if plan is not None else None,
        "plan_source": plan_source,
        "measured": measured,
        "device": device_record(device),
        "spec": devspecs.current_spec().name,
        "hw_fingerprint": devspecs.fingerprint(),
    }
    point.update(modeled)
    return point


def run_sweep(specs, grids, *, modes=("fused",), batches=(1,),
              n_steps: int = 2, reps: int = 2, warmup: int = 1,
              results_path: str = DEFAULT_RESULTS, resume: bool = True,
              tune: str = "none", distributed: bool = False,
              word_bytes: int = 4, registry: reg.PlanRegistry | None = None,
              verbose: bool = True, dtype_name: str = "f32",
              device: str = "cuda", shards: int | None = None) -> dict:
    """Run (or resume) a sweep and persist every point as it completes.

    Returns a summary dict: ``n_measured``, ``n_skipped``, ``seconds``,
    ``results_path`` and the target file's full point map. Points already
    present under the current hardware fingerprint in any sibling
    ``sweep*.json`` are skipped when `resume`; stale points (other
    fingerprint) are re-measured and overwritten. ``distributed=True``
    adds one distributed point per (stencil, grid) on `shards` shards.

    dtype_name: stream dtype of every point; the problems are generated at
    that dtype and `word_bytes` should be its word size so the plan
    registry and the traffic/model columns see the reduced word.
    """
    points = iter_points(specs, grids, modes, batches, n_steps, word_bytes,
                         dtype_name, distributed)
    return run_sweep_points(points, registry=registry or
                            reg.default_registry(),
                            results_path=results_path, resume=resume,
                            reps=reps, warmup=warmup, tune=tune,
                            verbose=verbose, device=device, shards=shards)


def _ecm_points(points) -> list[tuple[float, float, float]]:
    return [(p["flops"], p["traffic"]["hbm_bytes"], p["measured"]["t_s"])
            for p in points if not p.get("distributed")]


def calibration_summary(points) -> str:
    """One-line `fit_ecm` summary over measured points ("" if too few)."""
    pts = _ecm_points(points)
    if len(pts) < 3:
        return ""
    c = models.fit_ecm(pts)
    return (f"flops/s={c.flops_per_s:.3e} hbm_B/s={c.hbm_bytes_per_s:.3e} "
            f"dispatch={c.t_dispatch_s * 1e3:.2f}ms "
            f"max_rel_err={c.max_rel_err:.0%}")


def smoke_profile() -> dict:
    """The smoke sweep: all four paper stencils on tiny N^3 ladders, both
    execution modes, 2 steps (the reference's, less its distributed
    point)."""
    return {
        "specs": list(st.SPECS.values()),
        "modes": ("fused", "row"),
        "batches": (1,),
        "n_steps": 2,
        "reps": 2,
    }


def _smoke_points(word_bytes: int) -> list[PointSpec]:
    prof = smoke_profile()
    points = []
    for spec in prof["specs"]:
        grids = ladder(SMOKE_SIZES.get(spec.radius, SMOKE_SIZES[4]))
        points += iter_points([spec], grids, prof["modes"], prof["batches"],
                              prof["n_steps"], word_bytes)
    seven = st.SPECS["7pt-const"]
    n0 = SMOKE_SIZES[1][0]
    points.append(PointSpec(seven, (n0,) * 3, prof["n_steps"], True, 2,
                            word_bytes))
    # reduced-precision leg: one bf16 fused point per stencil at the first
    # ladder size, the rows the report's comparison and the gate read
    bf16_w = precision.word_bytes("bf16")
    for spec in prof["specs"]:
        n = SMOKE_SIZES.get(spec.radius, SMOKE_SIZES[4])[0]
        points.append(PointSpec(spec, (n,) * 3, prof["n_steps"], True, 1,
                                bf16_w, dtype_name="bf16"))
    return points


SCALING_DEVICE_LADDER = (1, 2, 4, 8)


def scaling_points(word_bytes: int = 4, *,
                   device_ladder=SCALING_DEVICE_LADDER,
                   n_steps: int = 8) -> list[PointSpec]:
    """The strong/weak scaling lattice (``--scaling``), the reference's.

    For 7pt-const and 25pt-const: a strong leg (global grid fixed at the
    ladder's top weak grid, shards shrink as their count grows) and a weak
    leg (per-shard grid fixed at 32^3), each under BOTH super-step
    schedules, so every rung yields an overlapped/synchronous pair
    (`launch.scaling_gate`). `elastic.plan_mesh` splits y only at these
    counts; the per-shard grids keep the zone split feasible at the top
    rung (local ny > 2g at t_block=2).
    """
    cases = [(st.SPECS["7pt-const"], (32, 32, 32)),
             (st.SPECS["25pt-const"], (32, 32, 32))]
    n_max = max(device_ladder)
    points = []
    for spec, per_dev in cases:
        nz, ny, nx = per_dev
        strong = (nz, ny * n_max, nx)
        for n in device_ladder:
            for scaling, grid in (("strong", strong),
                                  ("weak", (nz, ny * n, nx))):
                for overlap in (False, True):
                    points.append(PointSpec(
                        spec, grid, n_steps, True, 1, word_bytes,
                        distributed=True, n_devices=n, overlap=overlap,
                        scaling=scaling))
    return points


def run_sweep_points(points, *, registry: reg.PlanRegistry,
                     results_path: str, resume: bool = True, reps: int = 2,
                     warmup: int = 1, tune: str = "none",
                     verbose: bool = True, device: str = "cuda",
                     shards: int | None = None) -> dict:
    """`run_sweep` over an explicit, pre-built point list.

    Besides the per-point records, a finished run re-fits the ECM
    calibration over every point in the file and persists it as
    ``<results dir>/ecm-<spec>.json`` (`models.save_calibration`) whenever
    at least three points exist.
    """
    results = load_results(results_path)
    fp = devspecs.fingerprint()
    results["hw_fingerprint"] = fp
    done = done_keys(results_path) if resume else {}
    n_measured = n_skipped = 0
    t0 = time.perf_counter()
    for ps in points:
        if done.get(ps.key) == fp:
            n_skipped += 1
            if verbose:
                print(f"{ps.key},cached")
            continue
        point = run_point(ps, registry, reps=reps, warmup=warmup, tune=tune,
                          device=device, shards=shards)
        results["points"][ps.key] = point
        save_results(results_path, results)
        n_measured += 1
        if verbose:
            print(f"{ps.key},measured,{point['measured']['t_s']:.4f},"
                  f"{point['measured']['glups']:.5f},"
                  f"{point['traffic']['b_per_lup']:.2f},"
                  f"{point['model']['glups']:.2f}", flush=True)
    summary = {"n_measured": n_measured, "n_skipped": n_skipped,
               "seconds": time.perf_counter() - t0,
               "results_path": results_path, "points": results["points"]}
    calib_pts = _ecm_points(results["points"].values())
    if len(calib_pts) >= 3:
        calib = models.fit_ecm(calib_pts)
        summary["calibration_path"] = models.save_calibration(
            calib, os.path.dirname(results_path) or ".")
    if verbose:
        calib_line = calibration_summary(results["points"].values())
        print(f"# {n_measured} measured, {n_skipped} cached -> "
              f"{results_path} ({summary['seconds']:.1f}s); "
              f"registry {registry.stats()}"
              + (f"; fit {calib_line}" if calib_line else ""))
    return summary


def main(argv=None) -> dict:
    """CLI entry point; returns the sweep summary (tested directly)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep",
        description="Grid-size sweep: measured GLUP/s + K1's B/LUP + "
                    "model predictions into versioned JSON under "
                    "src/repro_torch/results/")
    ap.add_argument("--smoke", action="store_true",
                    help="a FIXED lattice (all four paper stencils on tiny "
                         "N^3 ladders, both modes, one batched point, a "
                         "bf16 leg, 2 steps) into "
                         f"{os.path.relpath(SMOKE_RESULTS)}; lattice flags "
                         "are rejected, timing flags apply")
    ap.add_argument("--scaling", action="store_true",
                    help="the FIXED strong/weak scaling lattice: overlapped "
                         "vs synchronous super-step pairs of the plain "
                         "route over the "
                         f"{'-'.join(map(str, SCALING_DEVICE_LADDER))} "
                         "shard ladder, into "
                         f"{os.path.relpath(SCALING_RESULTS)}; lattice "
                         "flags are rejected as with --smoke")
    ap.add_argument("--stencil", action="append",
                    help="stencil(s) to sweep: paper op, registered custom "
                         "op, or module.path:ATTR (default: all four)")
    ap.add_argument("--op-module", default=None,
                    help="import this module first (it registers custom "
                         "StencilOps via repro_torch.core.ir.register)")
    ap.add_argument("--sizes", type=str, default=None,
                    help="comma list of N for an N^3 grid ladder "
                         "(paper-style), e.g. 128,256,512")
    ap.add_argument("--grid", action="append",
                    help="explicit Z,Y,X grid (repeatable; combined with "
                         "--sizes)")
    ap.add_argument("--modes", type=str, default="fused",
                    help="comma list from {fused,row}")
    ap.add_argument("--batches", type=str, default="1",
                    help="comma list of serving batch sizes B (one "
                         "ops.mwd_batched call advances B grids)")
    ap.add_argument("--steps", type=int, default=2,
                    help="time steps each measured call advances")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed calls per point (median)")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--dtype", type=str, default="f32",
                    help="stream dtype of every point (f32/bf16/fp16); "
                         "problems are generated at this dtype and the "
                         "word size follows it")
    ap.add_argument("--word-bytes", type=int, default=None,
                    help="override the stream word size recorded on each "
                         "point (default: derived from --dtype)")
    ap.add_argument("--results", type=str, default=None,
                    help=f"results file (default "
                         f"{os.path.relpath(DEFAULT_RESULTS)}); resume "
                         "scans its directory")
    ap.add_argument("--no-resume", dest="resume", action="store_false",
                    help="re-measure every point even if already recorded")
    ap.add_argument("--tune", choices=("none", "model", "measured"),
                    default="none",
                    help="auto-tune each point's plan first and persist it "
                         "(bulk registry warming); 'none' resolves "
                         "registry-first with the model fallback")
    ap.add_argument("--distributed", action="store_true",
                    help="add a deep-halo super-stepper point (K1 per "
                         "shard) per (stencil, grid)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the --distributed points (default: one "
                         "per local card); with fewer cards the shards "
                         "share them")
    ap.add_argument("--registry", type=str, default=None,
                    help=f"plan registry path (default ${reg.ENV_VAR} or "
                         f"{reg.DEFAULT_PATH})")
    ap.add_argument("--expect-cached", action="store_true",
                    help="exit 1 if any point had to be measured (a finished "
                         "sweep resumes to zero work)")
    ap.add_argument("--spec", type=str, default=None,
                    help="device spec name or spec-file path the model "
                         "columns price against (default: "
                         f"${devspecs.ENV_SPEC} or "
                         f"{devspecs.DEFAULT_SPEC_NAME})")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    if args.spec:
        devspecs.set_default_spec(args.spec)
    if args.op_module:
        import importlib
        importlib.import_module(args.op_module)
    registry = (reg.PlanRegistry(args.registry) if args.registry
                else reg.default_registry())
    results_path = args.results or (
        SMOKE_RESULTS if args.smoke
        else SCALING_RESULTS if args.scaling else DEFAULT_RESULTS)
    dtype_name = precision.dtype_name(args.dtype)
    word_bytes = (args.word_bytes if args.word_bytes is not None
                  else precision.word_bytes(dtype_name))

    if args.smoke or args.scaling:
        fixed = "--smoke" if args.smoke else "--scaling"
        clash = [f for f, v, d in (
            ("--smoke --scaling", args.smoke and args.scaling, False),
            ("--stencil", args.stencil, None), ("--sizes", args.sizes, None),
            ("--grid", args.grid, None), ("--modes", args.modes, "fused"),
            ("--batches", args.batches, "1"), ("--steps", args.steps, 2),
            ("--dtype", dtype_name, "f32"),
            ("--distributed", args.distributed, False),
            ("--shards", args.shards, None)) if v != d]
        if clash:
            ap.error(f"{fixed} runs a fixed lattice; drop {' '.join(clash)}")
        points = (_smoke_points(word_bytes) if args.smoke
                  else scaling_points(word_bytes))
        summary = run_sweep_points(points,
                                   registry=registry,
                                   results_path=results_path,
                                   resume=args.resume, reps=args.reps,
                                   warmup=args.warmup, tune=args.tune,
                                   device=args.device)
    else:
        specs = [ir.resolve_op(n) for n in (args.stencil or st.SPECS)]
        grids = ladder(args.sizes.split(",")) if args.sizes else []
        for g in args.grid or []:
            grids.append(tuple(int(x) for x in g.split(",")))
        if not grids:
            grids = ladder((8, 12, 16))
        summary = run_sweep(
            specs, grids, modes=tuple(args.modes.split(",")),
            batches=tuple(int(b) for b in args.batches.split(",")),
            n_steps=args.steps, reps=args.reps, warmup=args.warmup,
            results_path=results_path, resume=args.resume, tune=args.tune,
            distributed=args.distributed, word_bytes=word_bytes,
            registry=registry, dtype_name=dtype_name, device=args.device,
            shards=args.shards)
    if args.expect_cached and summary["n_measured"]:
        raise SystemExit(
            f"--expect-cached: {summary['n_measured']} point(s) were "
            f"measured instead of resumed from {results_path}")
    return summary


if __name__ == "__main__":
    main()
