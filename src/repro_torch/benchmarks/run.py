"""The paper's benchmark harness on the port: one function per table or figure.

  python -m repro_torch.benchmarks.run [NAME] [--device cpu|cuda]

The port of ``benchmarks/run.py``. It prints ``name,us_per_call,derived``
CSV rows under the reference's row names, so that the two harnesses pair up
row by row; NAME runs the benches whose key contains it. The benches drive
the port's entry points (`kernels.ops`, `launch.soak`, `launch.fit`,
`training.steps`): K1, K2 and K3 on the card, their plain PyTorch versions
on the CPU. Times on the card come from CUDA events and on the CPU from
the host clock; every row ends with the device it ran on (``device=``), so
no CPU time reads as a device metric. Runs on ``cuda`` unless ``--device
cpu`` is given.

Sizes: on the CPU every bench runs at the reference's sizes (`REFERENCE`),
which the tests hold the rows against; on the card at the paper's
production grid, 512^3 (`CARD`). A row that runs smaller than its figure
names the cut (``cut=``).

Fields that named the TPU now name what they measure: ``v5e_model_GLUPs``
is ``h100_model_GLUPs`` (the K1 model, `models.k1_predict`), ``cpu_GLUPs``
is ``GLUPs``, ``vmem_fits_dw32`` is ``smem_fits_dw32``. ``Bc_kernel``,
``hbm_MB``, ``fused_MB``/``row_MB``, ``hbm_saved`` and ``launches`` keep the
reference's meaning, the bytes and launches of the paper's schedule as the
reference's kernel moves them (`schedule_dma`), on which the rows pair.
K1's own counts stand beside them: ``Bc_schedule``, ``k1_MB`` and
``k1_launches`` (one launch a diamond row in both modes, `core.traffic`).

The gates of smoke, custom_stencil, batched_serving, tuned_vs_default,
adjoint_fit, soak and lm_substrate (a finite loss) raise `GateFailed`
(soak's own `SoakFailed`).

  fig4_code_balance   Fig. 4      model vs schedule code balance across D_w
  table_ecm           Tables I/II the tuned plan's predictions (on the card
                                  beside the measured ops.mwd)
  fig8_15_perf        Figs. 8-15  naive, spatial (K2), ghost-zone (K3), MWD
                                  (K1) and plan="auto" across grid sizes
  fig16_18_groupsize  Figs. 16-18 the thread-group size sharing a tile, on
                                  Hopper K1's cluster
                                  (`stencil_mwd.prepare(cluster=)`): the
                                  model at every size and, on the card, K1
  fig19_energy        Fig. 19     energy vs code balance (the spec's
                                  constants)
  autotune_bench      Fig. 7      the tuner's model-scored search
  fused_vs_row        the fused schedule vs fresh grids every row
  tuned_vs_default    the registry's plan vs `MWDPlan()`
  smoke               correctness and traffic at tiny grids
  custom_stencil      a user's 19-point box op end to end
  batched_serving     one batched advance of B grids vs B calls
  soak                the mixed-traffic serving soak (`launch.soak`)
  adjoint_fit         `mwd_diff`'s gradients and the coefficient fit
  lm_substrate        one train step of the LM substrate (llama3.2-1b,
                      mamba2-130m, mixtral-8x7b) at the reduced 2-layer,
                      d64 configs, on the harness's clock
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import statistics
import time

import numpy as np
import torch

from repro_torch.core import autotune, ir, models, registry, tiling
from repro_torch.core import specs as devspecs
from repro_torch.core import stencils as st
from repro_torch.core import traffic
from repro_torch.core.mwd import MWDPlan, k1_geometry, run_mwd
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, stencil_fused, stencil_mwd, stencil_sweep


class GateFailed(AssertionError):
    """A bench's gate did not hold."""


def gate(cond: bool, what: str) -> None:
    if not cond:
        raise GateFailed(what)


def _custom_box_op() -> ir.StencilOp:
    # A user-defined operator that is NOT among the paper's four: a 19-point
    # variable-coefficient box (center + 6 faces + 12 edges), symmetric pairs
    # sharing one coefficient stream each -> 10 streams, 28 FLOPs/LUP derived.
    taps = [ir.Tap(0, 0, 0, ir.array(0))]
    k = 1
    for ax in range(3):                      # 6 faces -> 3 symmetric pairs
        o = [0, 0, 0]
        o[ax] = 1
        taps += [ir.Tap(*o, ir.array(k)),
                 ir.Tap(*[-v for v in o], ir.array(k))]
        k += 1
    for a in range(3):                       # 12 edges -> 6 symmetric pairs
        for b in range(a + 1, 3):
            for sb in (1, -1):
                o = [0, 0, 0]
                o[a], o[b] = 1, sb
                taps += [ir.Tap(*o, ir.array(k)),
                         ir.Tap(*[-v for v in o], ir.array(k))]
                k += 1
    return ir.register(ir.StencilOp("box19-var", tuple(taps),
                                    coeff_scale=0.05))


CUSTOM_BOX = _custom_box_op()


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The benches' problem sizes on one kind of device."""

    perf: tuple[int, ...]          # fig8_15: n of each n^3 grid
    clusters: tuple[int, ...]      # fig16_18: cluster sizes; () = 1..max
    groupsize_k1: int | None       # fig16_18: n of K1's measured leg
    fused_vs_row: tuple | None     # None: the reference's grid per radius
    tuned: tuple | None            # None: `registry.default_grid`
    custom: tuple                  # (grid, steps)
    batched: tuple                 # (B, grid, steps)


MAIN = (512, 512, 512)              # the paper's production grid
GROUPSIZE_GRID = (1024, 1024, 1024)  # the reference's Figs. 16-18 grid
REFERENCE = Sizes(perf=(48, 64), clusters=(1, 2, 4, 8, 16),
                  groupsize_k1=None, fused_vs_row=None, tuned=None,
                  custom=((8, 14, 12), 3), batched=(4, (6, 10, 8), 3))
CARD = Sizes(perf=(128, 256, 512), clusters=(), groupsize_k1=512,
             fused_vs_row=MAIN, tuned=MAIN, custom=(MAIN, 3),
             batched=(4, (128, 128, 128), 3))


@dataclasses.dataclass
class Row:
    """One CSV row; `data` keeps the raw numbers a caller reads back."""

    name: str
    us: float
    derived: str
    data: dict = dataclasses.field(default_factory=dict)

    def csv(self) -> str:
        return f"{self.name},{self.us:.1f},{self.derived}"


@contextlib.contextmanager
def uncounted():
    """Launches inside are checks against a plain version: the kernels'
    launch counts come back as they were."""
    mods = (stencil_mwd, stencil_sweep, stencil_fused)
    saved = [m.LAUNCHES.count for m in mods]
    try:
        yield
    finally:
        for m, n in zip(mods, saved):
            m.LAUNCHES.count = n


class Bench:
    """One harness run: the device, its sizes and the rows so far."""

    def __init__(self, device="cuda", echo: bool = True):
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.sizes = CARD if self.cuda else REFERENCE
        self.device_name = (torch.cuda.get_device_name(self.device)
                            if self.cuda else "cpu")
        self.rows: list[Row] = []
        self.echo = echo

    def row(self, name: str, us: float, derived: str, **data) -> None:
        r = Row(name, us, f"{derived};device={self.device_name}", data)
        self.rows.append(r)
        if self.echo:
            print(r.csv(), flush=True)

    def problem(self, spec, shape, seed: int = 0):
        """The reference's numbers on the CPU; on the card the same
        distribution drawn there (`random_problem`: host draws take
        seconds a 512^3 volume)."""
        if self.cuda:
            return st.random_problem(spec, shape, seed=seed,
                                     device=self.device)
        return st.make_problem(spec, shape, seed=seed, device=self.device)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def wall_us(self, fn) -> float:
        """µs of one call of `fn`: CUDA events around it on the card (host
        waits inside count), the host clock on the CPU."""
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3

    def time_us(self, fn, reps: int = 1) -> float:
        """Mean µs of `fn` over `reps` calls (at least 3 on the card) after
        one untimed call, as the reference's ``_t``."""
        fn()
        self.sync()
        reps = max(reps, 3) if self.cuda else reps

        def loop():
            for _ in range(reps):
                fn()
            self.sync()

        return self.wall_us(loop) / reps


def _plan(p: MWDPlan) -> str:
    return f"dw{p.d_w}.nf{p.n_f}.{'fused' if p.fused else 'row'}"


def _f(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _same(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def schedule_dma(spec, grid_shape, n_steps: int, d_w: int, n_f: int,
                 fused: bool = True, word: int = 4) -> dict:
    """Bytes and launches of the paper's schedule as the reference's kernel
    moves them: every tile it runs streams its window and emits its strip
    (`models.mwd_tile_bytes`); fused, one launch over the active tiles,
    per-row one launch a row over every tile (the reference's
    `mwd_run_traffic`)."""
    nz, ny, nx = grid_shape
    r = spec.radius
    comp = tiling.compile_schedule(
        tiling.make_diamond_schedule(d_w, r, n_steps, r, ny - r))
    tiles = comp.n_active if fused else comp.n_rows * comp.n_tiles
    b = tiles * models.mwd_tile_bytes(spec, d_w, n_f, nz, nx, word)
    return {"bytes": float(b), "code_balance": b / (nz * ny * nx * n_steps),
            "launches": 1 if fused else comp.n_rows}


def k1_model(spec, grid_shape, plan: MWDPlan, n_steps: int,
             cluster: int | None = None):
    """`models.k1_predict` for the plan, or None where K1 does not take it
    (the fit twin, `models.smem_fits`)."""
    if not (autotune._plan_valid(spec, plan) and models.smem_fits(
            spec, plan.d_w, plan.n_f, grid_shape[2], cluster=cluster)):
        return None
    return models.k1_predict(spec, grid_shape, plan.d_w, plan.n_f, n_steps,
                             fused=plan.fused, cluster=cluster)


def _glups(pred) -> float | None:
    return None if pred is None else pred.lups / pred.t_total / 1e9


def fig4_code_balance(b: Bench) -> None:
    """Model (Eq. 3/5) vs the schedules' code balance across D_w."""
    grid = (128, 128, 128)
    cells = float(np.prod(grid))
    for name, spec in st.SPECS.items():
        step = 2 * spec.radius
        for d_w in [step * k for k in (1, 2, 4, 8, 16)]:
            n_xb = grid[2] * 4 * spec.bytes_per_cell
            cs = models.cache_block_bytes(spec, d_w, 2, n_xb)
            bc_model = models.code_balance(spec, d_w, 4)
            n_f, h = min(2, d_w), d_w // step
            tiles = grid[1] // d_w + 3          # one row of the reference's
            bc_kernel = (tiles * models.mwd_tile_bytes(
                spec, d_w, n_f, grid[0], grid[2]) / (cells * h))
            bc_sched = models.mwd_schedule_bytes(spec, grid, d_w, 1) / (
                cells * h)
            b.row(f"fig4.{name}.dw{d_w}", 0.0,
                  f"block_KiB={cs/1024:.0f};Bc_model={bc_model:.2f};"
                  f"Bc_kernel={bc_kernel:.2f};Bc_schedule={bc_sched:.2f}")


def table_ecm(b: Bench) -> None:
    """ECM and K1-model predictions at the tuned plan (Tables I/II), on
    the card beside the measured `ops.mwd` at that plan."""
    grid, n_steps = MAIN, autotune.MODEL_STEPS
    cells = float(np.prod(grid))
    for name, spec in st.SPECS.items():
        plan = autotune.autotune(spec, grid, devices_x=1).plan
        bc = models.code_balance(spec, plan.d_w, 4)
        pred = models.ecm_predict(spec, bc, cells)
        spat = models.ecm_predict(spec, models.spatial_code_balance(spec, 4),
                                  cells)
        k1 = _glups(k1_model(spec, grid, plan, n_steps))
        derived = (f"dw={plan.d_w};nf={plan.n_f};Bc={bc:.2f}B/LUP;"
                   f"pred_GLUPs={pred.glups:.1f};"
                   f"spatial_GLUPs={spat.glups:.1f};"
                   f"speedup={pred.glups/spat.glups:.2f}x;"
                   f"h100_model_GLUPs={_f(k1, '.2f')}")
        us = 0.0
        if b.cuda:
            state, coeffs = b.problem(spec, grid)
            us = b.time_us(lambda: ops.mwd(spec, state, coeffs, n_steps,
                                           plan=plan))
            derived += f";GLUPs={cells * n_steps / us / 1e3:.2f};steps=8"
            del state, coeffs
        b.row(f"ecm.{name}", us, derived)


def fig8_15_perf(b: Bench) -> None:
    """The four methods across grid sizes, with the K1 model beside MWD."""
    t_steps = 4
    for name, spec in st.SPECS.items():
        d_w = 8 if spec.radius == 1 else 16
        for n in b.sizes.perf:
            shape = (n, n, n)
            state, coeffs = b.problem(spec, shape)
            lups = float(np.prod(shape)) * t_steps
            auto = ops.resolve_plan(spec, state, "auto")
            fixed = MWDPlan(d_w=d_w)
            runs = (
                ("naive", None, lambda: ops.naive(spec, state, coeffs,
                                                  t_steps)),
                ("spatial", None, lambda: ops.spatial(spec, state, coeffs,
                                                      t_steps)),
                ("ghostzone", None, lambda: ops.ghostzone(
                    spec, state, coeffs, t_steps)),
                ("mwd", fixed, lambda: ops.mwd(spec, state, coeffs, t_steps,
                                               plan=fixed)),
                ("auto", auto, lambda: ops.mwd(spec, state, coeffs, t_steps,
                                               plan=auto)))
            for method, plan, fn in runs:
                us = b.time_us(fn)
                derived = f"GLUPs={lups / us / 1e3:.3f}"
                if plan is not None:
                    model = _glups(k1_model(spec, shape, plan, t_steps))
                    derived += (f";plan={_plan(plan)};"
                                f"h100_model_GLUPs={_f(model, '.1f')}")
                b.row(f"perf.{name}.{method}.{n}", us, derived)
            del state, coeffs


def _cluster_fields(spec, grid, plan, cluster, n_steps, chip):
    """The fit twin and the K1 model at `cluster` CTAs a tile."""
    smem = models.mwd_smem_plan(spec, plan.d_w, plan.n_f, grid[2], chip=chip,
                                cluster=cluster)
    fits = smem is not None and smem.per_sm >= 1
    pred = k1_model(spec, grid, plan, n_steps, cluster) if fits else None
    return smem, pred


def fig16_18_groupsize(b: Bench) -> None:
    """The thread-group size sharing one tile (the reference's tg_x): on
    Hopper K1's cluster. Model leg at 1024^3 for every size, for the
    model's tuned plan and the reference's dw32.nf2; on the card K1
    measured at 512^3 at each size it takes (`_groupsize_k1`)."""
    chip = devspecs.current_spec()
    clusters = b.sizes.clusters or tuple(range(1, chip.max_cluster + 1))
    grid, n_steps = GROUPSIZE_GRID, autotune.MODEL_STEPS
    ref = MWDPlan(d_w=32, n_f=2)
    for name in ("7pt-const", "25pt-var"):
        spec = st.SPECS[name]
        tuned = autotune.autotune(spec, grid, devices_x=1,
                                  d_w_cap=grid[1]).plan
        for c in clusters:
            smem, pred = _cluster_fields(spec, grid, tuned, c, n_steps, chip)
            ref_smem, ref_pred = _cluster_fields(spec, grid, ref, c, n_steps,
                                                 chip)
            b.row(f"groupsize.{name}.tg{c}", 0.0,
                  f"plan={_plan(tuned)};smem_fits={pred is not None};"
                  f"smem_KiB={_f(smem and smem.smem_bytes / 1024, '.1f')};"
                  f"ctas_sm={_f(smem and smem.per_sm, 'd')};"
                  f"model_ms={_f(pred and pred.t_total * 1e3, '.2f')};"
                  f"model_GLUPs={_f(_glups(pred), '.1f')};"
                  f"smem_fits_dw32={ref_pred is not None};"
                  f"model_GLUPs_dw32={_f(_glups(ref_pred), '.1f')};"
                  f"grid=1024^3x{n_steps}",
                  op=name, plan=_plan(tuned), cluster=c,
                  fits=pred is not None,
                  model_ms=pred and pred.t_total * 1e3,
                  smem_bytes=smem and smem.smem_bytes,
                  ctas_sm=smem and smem.per_sm)
        if b.sizes.groupsize_k1:
            _groupsize_k1(b, spec, clusters, chip)


def _k1_alone_us(job, reps: int = 3) -> float:
    """Median µs of K1 alone on a prepared CUDA job by CUDA events, the
    grids restored untimed before each run (and after)."""
    saved = [x.clone() for x in job.bufs]
    times = []
    for _ in range(reps):
        for x, s in zip(job.bufs, saved):
            x.copy_(s)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        stencil_mwd.run_kernel(job)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    for x, s in zip(job.bufs, saved):
        x.copy_(s)
    return statistics.median(times) * 1e3


def _groupsize_k1(b: Bench, spec, clusters, chip) -> None:
    """K1 at each forced cluster size, 512^3 x 8 steps (1024^3 needs
    about 15 grids of 4.3 GB at 25pt-var beside padded copies, more than
    the card holds): the run registry's plan (tuned on the card) and the
    reference's dw32.nf2. Each size that launches is held bitwise against
    the plain version; a refusal is recorded, not raised."""
    n = b.sizes.groupsize_k1
    grid, n_steps = (n, n, n), autotune.MODEL_STEPS
    state, coeffs = b.problem(spec, grid)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    tuned, source = registry.resolve_plan(spec, grid)
    for plan in (tuned, MWDPlan(d_w=32, n_f=2)):
        kw = dict(d_w=plan.d_w, n_f=plan.n_f, fused=plan.fused)
        want = None
        for c in clusters:
            smem, pred = _cluster_fields(spec, grid, plan, c, n_steps, chip)
            job = stencil_mwd.prepare(spec, state, arrays, scalars, n_steps,
                                      cluster=c, **kw)
            common = (f"plan={_plan(plan)};source={source};"
                      f"model_ms={_f(pred and pred.t_total * 1e3, '.3f')};"
                      f"twin_fits={smem is not None};"
                      f"grid={n}^3x{n_steps};cut=1024^3->{n}^3 (memory)")
            data = dict(op=spec.name, plan=_plan(plan), cluster=c,
                        model_ms=pred and pred.t_total * 1e3,
                        twin=smem and dataclasses.asdict(smem))
            name = f"groupsize.{spec.name}.k1.{_plan(plan)}.tg{c}"
            try:
                cfg = stencil_mwd.kernel_config(job)
            except stencil_mwd.LaunchRefused as e:
                b.row(name, 0.0, f"fits=False;refused={e.code};{common}",
                      fits=False, refused=e.code, **data)
                continue
            if want is None:
                plain = stencil_mwd.prepare(spec, state, arrays, scalars,
                                            n_steps, **kw)
                stencil_mwd.run_plain(plain)
                want = plain.bufs
                del plain
            saved = [x.clone() for x in job.bufs]
            with uncounted():
                stencil_mwd.run_kernel(job)
            b.sync()
            if not _same(job.bufs, want):
                err = max(_err(x, w) for x, w in zip(job.bufs, want))
                raise GateFailed(f"{spec.name} {_plan(plan)} cluster={c}: "
                                 f"K1 != its plain version (max err {err})")
            for x, s in zip(job.bufs, saved):
                x.copy_(s)
            del saved
            us = _k1_alone_us(job)
            b.row(name, us,
                  f"fits=True;k1_ms={us / 1e3:.3f};{common};"
                  f"smem_KiB={cfg['smem_bytes'] / 1024:.1f};"
                  f"ctas_sm={_f(smem and smem.per_sm, 'd')};"
                  f"slab={cfg['slab']};threads={cfg['threads']};"
                  f"stage={cfg['stage']};"
                  f"max_active_clusters={cfg['max_active_clusters']};"
                  f"bitwise=True",
                  fits=True, k1_ms=us / 1e3, config=cfg, bitwise=True,
                  **data)
            del job
        del want
    del state, coeffs, arrays


def fig19_energy(b: Bench) -> None:
    """Energy vs code balance at varying D_w (Fig. 19), the spec's
    constants."""
    grid = MAIN
    lups = float(np.prod(grid))
    for name, spec in st.SPECS.items():
        step = 2 * spec.radius
        for d_w in (step * 2, step * 8, step * 32):
            bc = models.code_balance(spec, d_w, 4)
            pred = models.ecm_predict(spec, bc, lups)
            e = models.energy(spec.flops_per_lup * lups, bc * lups,
                              pred.t_total)
            b.row(f"energy.{name}.dw{d_w}", 0.0,
                  f"Bc={bc:.1f};core_J={e.core_j:.2f};hbm_J={e.hbm_j:.2f};"
                  f"total_J={e.total_j:.2f};"
                  f"pJ_per_LUP={e.total_j/lups*1e12:.1f}")


def autotune_bench(b: Bench) -> None:
    """The model-scored search at 512^3 (Fig. 7) on one device: the port
    scores tg_x = 1 only, so the reference's devices_x = 16 is cut."""
    t0 = time.perf_counter()
    for name, spec in st.SPECS.items():
        res = autotune.autotune(spec, MAIN, devices_x=1)
        b.row(f"autotune.{name}", (time.perf_counter() - t0) * 1e6,
              f"plan=dw{res.plan.d_w}.nf{res.plan.n_f}.tg{res.plan.tg_x};"
              f"score={res.score:.1f};evals={len(res.evaluated)};"
              f"cut=devices_x 16->1")


def fused_vs_row(b: Bench) -> None:
    """The fused schedule vs fresh grids every row: time, bytes, GLUP/s."""
    t_steps = 4
    for name, spec in st.SPECS.items():
        shape = b.sizes.fused_vs_row or (
            (10, 18, 14) if spec.radius == 1 else (12, 26, 18))
        d_w, n_f = 4 * spec.radius, 2
        state, coeffs = b.problem(spec, shape)
        lups = float(np.prod(shape)) * t_steps
        us_f = b.time_us(lambda: ops.mwd(spec, state, coeffs, t_steps,
                                         d_w=d_w, n_f=n_f, fused=True))
        us_r = b.time_us(lambda: ops.mwd(spec, state, coeffs, t_steps,
                                         d_w=d_w, n_f=n_f, fused=False))
        tf = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=True)
        tr = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=False)
        kf = traffic.mwd_run_traffic(spec, shape, t_steps, d_w, n_f,
                                     fused=True)
        kr = traffic.mwd_run_traffic(spec, shape, t_steps, d_w, n_f,
                                     fused=False)
        model = _glups(k1_model(spec, shape, MWDPlan(d_w=d_w, n_f=n_f),
                                t_steps))
        overhead = (models.mwd_row_overhead_bytes(spec, d_w, n_f, shape)
                    * tr["launches"])
        b.row(f"fusedrow.{name}.fused", us_f,
              f"GLUPs={lups/us_f/1e3:.4f};hbm_MB={tf['bytes']/1e6:.2f};"
              f"launches={tf['launches']};k1_MB={kf['bytes']/1e6:.2f};"
              f"k1_launches={kf['launches']};"
              f"h100_model_GLUPs={_f(model, '.1f')}")
        b.row(f"fusedrow.{name}.row", us_r,
              f"GLUPs={lups/us_r/1e3:.4f};hbm_MB={tr['bytes']/1e6:.2f};"
              f"launches={tr['launches']};k1_MB={kr['bytes']/1e6:.2f};"
              f"k1_launches={kr['launches']};"
              f"hbm_saved={1 - tf['bytes']/tr['bytes']:.1%};"
              f"k1_saved={1 - kf['bytes']/kr['bytes']:.1%};"
              f"row_overhead_MB={overhead/1e6:.2f}")
        del state, coeffs


def tuned_vs_default(b: Bench) -> None:
    """The registry's plan vs the untuned default `MWDPlan()`.

    The plan resolves registry-first (a measured entry where
    `launch.tune` ran for the grid, else the model-scored tuner). The gate
    is the reference's: a measured plan may not run more than 5 % slower
    than the default unless the model scores it no lower; a model plan
    must score no lower than the default, which the search evaluates
    first.
    """
    t_steps = 4
    for name, spec in st.SPECS.items():
        shape = b.sizes.tuned or registry.default_grid(spec)
        state, coeffs = b.problem(spec, shape)
        lups = float(np.prod(shape)) * t_steps
        tuned, source = registry.resolve_plan(spec, shape, word_bytes=4)
        default = MWDPlan()
        score = autotune.model_score(spec, shape, 4)
        s_tuned, s_default = score(tuned), score(default)
        us_t = b.time_us(lambda: ops.mwd(spec, state, coeffs, t_steps,
                                         plan=tuned), reps=3)
        us_d = b.time_us(lambda: ops.mwd(spec, state, coeffs, t_steps,
                                         plan=default), reps=3)
        if source == "registry:measured":
            ok = us_t <= 1.05 * us_d or s_tuned >= s_default
        else:
            ok = s_tuned >= s_default
        gate(ok, f"tuned plan below default for {name}: model "
                 f"{s_tuned:.2f} vs {s_default:.2f} GLUP/s, measured "
                 f"{us_t:.0f} vs {us_d:.0f} us")
        b.row(f"tuned.{name}", us_t,
              f"source={source};plan={_plan(tuned)};"
              f"model_GLUPs={s_tuned:.2f};GLUPs={lups/us_t/1e3:.4f}")
        b.row(f"default.{name}", us_d,
              f"plan={_plan(default)};model_GLUPs={s_default:.2f};"
              f"GLUPs={lups/us_d/1e3:.4f};tuned_speedup={us_d/us_t:.2f}x")
        del state, coeffs


def smoke(b: Bench) -> None:
    """Correctness and traffic at tiny grids; raises on a regression.

    1. the fused `ops.mwd` equals the `run_mwd` oracle: bitwise on the CPU
       (the reference's gate); on the card K1 bitwise equal to its plain
       version on the same inputs and `ops.mwd` within
       ``op.tolerance("f32")`` of the oracle, the difference in the row;
    2. the fused schedule's bytes below the per-row path's, in the
       reference's count and in K1's;
    3. the model-scored tuner picks a fused plan.
    """
    for name in ("7pt-const", "25pt-const"):
        spec = st.SPECS[name]
        shape = (8, 14, 10) if spec.radius == 1 else (10, 18, 14)
        d_w, n_f, t_steps = 2 * spec.radius, 2, 3
        state, coeffs = b.problem(spec, shape)
        want = run_mwd(spec, state, coeffs, t_steps, MWDPlan(d_w=d_w))
        got = ops.mwd(spec, state, coeffs, t_steps, d_w=d_w, n_f=n_f)
        exact = _same(got, want)
        err = max(_err(g, w) for g, w in zip(got, want))
        if b.cuda:
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            kw = dict(d_w=d_w, n_f=n_f, fused=True)
            jk = stencil_mwd.prepare(spec, state, arrays, scalars, t_steps,
                                     **kw)
            jp = stencil_mwd.prepare(spec, state, arrays, scalars, t_steps,
                                     **kw)
            with uncounted():
                stencil_mwd.run_kernel(jk)
            stencil_mwd.run_plain(jp)
            b.sync()
            gate(_same(jk.bufs, jp.bufs),
                 f"K1 != its plain version for {name}")
            atol, rtol = spec.tolerance("f32")
            gate(all(bool(((g.double() - w.double()).abs()
                           <= atol + rtol * w.double().abs()).all())
                     for g, w in zip(got, want)),
                 f"fused kernel beyond tolerance of the oracle for {name}: "
                 f"{err}")
            check = (f"kernel_eq_plain_bitwise=True;oracle_bitwise={exact};"
                     f"oracle_err={err:.1e};tol_f32={atol:.1e}/{rtol:.1e}")
        else:
            gate(exact, f"fused kernel != oracle for {name}")
            check = f"fused_eq_oracle_bitwise={exact}"
        tf = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=True)
        tr = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=False)
        kf = traffic.mwd_run_traffic(spec, shape, t_steps, d_w, n_f,
                                     fused=True)
        kr = traffic.mwd_run_traffic(spec, shape, t_steps, d_w, n_f,
                                     fused=False)
        gate(tf["bytes"] < tr["bytes"] and kf["bytes"] < kr["bytes"],
             f"fused traffic not below per-row for {name}")
        b.row(f"smoke.{name}", 0.0,
              f"{check};fused_MB={tf['bytes']/1e6:.2f};"
              f"row_MB={tr['bytes']/1e6:.2f};"
              f"launches={tr['launches']}->1;k1_MB={kf['bytes']/1e6:.2f};"
              f"k1_row_MB={kr['bytes']/1e6:.2f};"
              f"k1_launches={kf['launches']}")
    res = autotune.autotune(st.SPECS["7pt-var"], (128, 128, 128),
                            devices_x=1)
    gate(res.plan.fused, "auto-tuner should pick the fused schedule")
    b.row("smoke.autotune", 0.0,
          f"plan=dw{res.plan.d_w}.nf{res.plan.n_f}.fused;"
          f"score={res.score:.1f}")


def custom_stencil(b: Bench) -> None:
    """A user-defined op end to end with no kernel edits.

    `CUSTOM_BOX` (a variable-coefficient 19-point box) through the fused
    MWD launch and plan="auto", each within the reference's 1e-4 of
    `ops.naive` (``op.tolerance("f32")`` beside it), with the IR's
    analytics and both counts of fused and per-row bytes.
    """
    spec = CUSTOM_BOX
    shape, t_steps = b.sizes.custom
    d_w, n_f = 4, 2
    state, coeffs = b.problem(spec, shape)
    want = ops.naive(spec, state, coeffs, t_steps)
    us = b.time_us(lambda: ops.mwd(spec, state, coeffs, t_steps, d_w=d_w,
                                   n_f=n_f, fused=True))
    got = ops.mwd(spec, state, coeffs, t_steps, d_w=d_w, n_f=n_f, fused=True)
    err = _err(want[0], got[0])
    gate(err < 1e-4, f"custom op fused MWD != naive oracle: {err}")
    auto = ops.mwd(spec, state, coeffs, t_steps, plan="auto")
    err_auto = _err(want[0], auto[0])
    gate(err_auto < 1e-4,
         f"custom op plan='auto' != naive oracle: {err_auto}")
    tf = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=True)
    tr = schedule_dma(spec, shape, t_steps, d_w, n_f, fused=False)
    gate(tf["bytes"] < tr["bytes"], "custom op: fused traffic not below "
                                    "per-row")
    kf = traffic.mwd_run_traffic(spec, shape, t_steps, d_w, n_f, fused=True)
    atol, rtol = spec.tolerance("f32")
    b.row(f"custom.{spec.name}", us,
          f"flops={spec.flops_per_lup};streams={spec.n_streams};"
          f"fingerprint={spec.fingerprint};err_fused={err:.1e};"
          f"err_auto={err_auto:.1e};tol_f32={atol:.1e}/{rtol:.1e};"
          f"fused_MB={tf['bytes']/1e6:.2f};row_MB={tr['bytes']/1e6:.2f};"
          f"k1_MB={kf['bytes']/1e6:.2f};grid={'x'.join(map(str, shape))}")


def batched_serving(b: Bench) -> None:
    """One batched advance of B grids vs B calls that each wait.

    B same-shaped requests (own grids and per-cell coefficients, shared
    scalars) advance once one by one, the host waiting for each as a
    serving loop does before it answers, and once in one
    `ops.mwd_batched` call, at one plan (on the card ``"auto"`` for the
    batch, on the CPU the reference's dw2.nf1). Asserts the batched
    result equal bit for bit and its throughput no lower (the best of
    interleaved reps, one retry).
    """
    n_b, shape, t_steps = b.sizes.batched
    reps = 5
    for spec in (st.SPECS["7pt-const"], st.SPECS["7pt-var"]):
        probs = [b.problem(spec, shape, seed=i) for i in range(n_b)]
        states = [p[0] for p in probs]
        coeffs = [p[1] for p in probs]
        plan = (ops.resolve_plan(spec, states[0], "auto", batch=n_b)
                if b.cuda else MWDPlan(d_w=2, n_f=1))

        def run_seq():
            out = []
            for s, c in zip(states, coeffs):
                out.append(ops.mwd(spec, s, c, t_steps, plan=plan))
                b.sync()
            return out

        def run_bat():
            out = ops.mwd_batched(spec, states, coeffs, t_steps, plan=plan)
            b.sync()
            return out

        seq, bat = run_seq(), run_bat()        # warm both paths
        run_seq(), run_bat()
        for i in range(n_b):
            gate(torch.equal(seq[i][0], bat[0][i])
                 and torch.equal(seq[i][1], bat[1][i]),
                 f"batched != sequential for {spec.name} item {i}")

        def measure():
            # interleaved, so drift hits both paths alike
            ts_seq, ts_bat = [], []
            for _ in range(reps):
                ts_seq.append(b.wall_us(run_seq))
                ts_bat.append(b.wall_us(run_bat))
            return min(ts_seq), min(ts_bat)

        t_seq, t_bat = measure()
        if t_bat > t_seq:                      # absorb one spike, then gate
            t_seq, t_bat = measure()
        lups = float(np.prod(shape)) * t_steps * n_b
        thr_seq, thr_bat = lups / t_seq / 1e3, lups / t_bat / 1e3
        gate(thr_bat >= thr_seq,
             f"batched serving slower than sequential for {spec.name}: "
             f"{thr_bat:.5f} vs {thr_seq:.5f} GLUP/s at B={n_b}")
        rows = k1_geometry(spec.radius, shape, plan.d_w, plan.n_f,
                           t_steps).comp.n_rows
        b.row(f"batched.{spec.name}.B{n_b}", t_bat,
              f"bitwise_eq=True;seq_GLUPs={thr_seq:.5f};"
              f"bat_GLUPs={thr_bat:.5f};speedup={t_seq/t_bat:.2f}x;"
              f"calls={n_b}->1;k1_launches={n_b * rows}->{rows};"
              f"plan={_plan(plan)};grid={'x'.join(map(str, shape))}")
        del probs, states, coeffs, seq, bat


def soak(b: Bench) -> None:
    """The mixed-traffic serving soak and its checks (`launch.soak`)."""
    from repro_torch.launch import soak as soakmod
    path = soakmod.report_path()
    rep = soakmod.run_soak(b.device, path)
    b.row(f"soak.{rep['op']}", rep["wall_s"] * 1e6,
          f"p99_ms={rep['p99_ms']:.1f};dropped={rep['dropped']};"
          f"bitwise={rep['bitwise_ok']};classes={len(rep['classes'])};"
          f"batches={len(rep['batch_sizes'])};"
          f"thr_ratio={rep['throughput_ratio']:.2f}x;report={path}")


def adjoint_fit(b: Bench) -> None:
    """Gradients of `mwd_diff` and a seeded coefficient fit.

    (a) `mwd_diff`'s gradient wrt the coefficient streams against autograd
    through `ops.naive`, for a 1st- and a 2nd-order op, within the
    reference's 1e-4 of the largest gradient, with the forward and the
    forward + backward times; (b) `launch.fit` on 7pt-var must cut the
    observation loss at least 10x in 40 steps.
    """
    from repro_torch.launch import fit as fitmod

    for name in ("7pt-var", "25pt-const"):
        spec = st.SPECS[name]
        shape = (8, 12, 10) if spec.radius == 1 else (14, 20, 16)
        d_w = 4 if spec.radius == 1 else 8
        state, coeffs = b.problem(spec, shape)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        w = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shape).astype(np.float32)).to(b.device)

        def loss(fn, arr):
            out = fn(spec, state, ir.join_coeffs(spec, arr, scalars), 2,
                     d_w=d_w, n_f=2)
            return torch.sum(out[0] * w)

        def grad(fn):
            arr = arrays.detach().clone().requires_grad_(True)
            loss(fn, arr).backward()
            return arr.grad

        g_ref = grad(lambda s, st_, c, n, **_: ops.naive(s, st_, c, n))
        us_f = b.time_us(lambda: loss(ops.mwd_diff, arrays))
        us_b = b.time_us(lambda: grad(ops.mwd_diff))
        g_got = grad(ops.mwd_diff)
        err = _err(g_ref, g_got)
        scale = float(g_ref.abs().max()) or 1.0
        gate(err <= 1e-4 * scale,
             f"adjoint gradcheck failed for {name}: {err} vs scale {scale}")
        b.row(f"adjoint.{name}", us_b,
              f"grad_err={err:.1e};fwd_us={us_f:.0f};"
              f"bwd_over_fwd={us_b/us_f:.2f}x")

    rep = fitmod.run_fit(st.SPECS["7pt-var"], (8, 12, 10), n_steps=2,
                         windows=2, seed=0, max_steps=40, telemetry="",
                         device=b.device)
    gate(rep["reduction"] >= 10.0,
         f"fit gate: only {rep['reduction']:.1f}x loss reduction")
    b.row("adjoint.fit.7pt-var", rep["seconds"] * 1e6,
          f"loss0={rep['loss0']:.2e};loss={rep['loss']:.2e};"
          f"reduction={rep['reduction']:.0f}x;steps={rep['steps']}")


def lm_substrate(b: Bench) -> None:
    """One train step of the LM substrate per family the reference times
    (dense, SSM, MoE): the reduced 2-layer, d64 configs, batch 2 x 64
    tokens of zeros, seed-0 weights, the config's optimizer. No stencil
    kernel runs here: the products are `torch.matmul`."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models.params import count_params, tree_init
    from repro_torch.training import steps as tsteps

    for arch in ("llama3.2-1b", "mamba2-130m", "mixtral-8x7b"):
        cfg = configs.reduced(configs.get(arch), n_layers=2, d_model=64)
        specs = lm.param_specs(cfg)
        params = tree_init(specs, seed=0, device=b.device)
        toks = torch.zeros((2, 64), dtype=torch.int32, device=b.device)
        batch = {"tokens": toks, "labels": toks}
        opt, train = tsteps.make_train_step(cfg, chunk=32)
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        loss = float(train(state, batch)[1]["loss"])
        gate(math.isfinite(loss), f"lm_substrate: {arch} loss {loss}")
        us = b.time_us(lambda: train(state, batch)[1]["loss"], reps=3)
        b.row(f"lm.train_step.{arch}", us,
              f"reduced_cfg_2L_d64;params={count_params(specs)};"
              f"tokens=128;loss={loss:.4f}", arch=arch, loss=loss)


BENCHES = {
    "fig4_code_balance": fig4_code_balance,
    "table_ecm": table_ecm,
    "fig8_15_perf": fig8_15_perf,
    "fig16_18_groupsize": fig16_18_groupsize,
    "fig19_energy": fig19_energy,
    "autotune_bench": autotune_bench,
    "fused_vs_row": fused_vs_row,
    "tuned_vs_default": tuned_vs_default,
    "smoke": smoke,
    "custom_stencil": custom_stencil,
    "batched_serving": batched_serving,
    "soak": soak,
    "adjoint_fit": adjoint_fit,
    "lm_substrate": lm_substrate,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("name", nargs="?", default=None,
                    help="run the benches whose name contains this")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    b = Bench(args.device)
    for name, fn in BENCHES.items():
        if not args.name or args.name in name:
            fn(b)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
