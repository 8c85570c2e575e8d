#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check, run, serve.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER_CHECKOUT
    python3 chip_smoke.py --sweep-k2 | --sweep-k3 | --calibrate OUT_DIR

Run from a checkout of the repository on a machine with a CUDA card (an
H100: the kernels build for sm_90a). Phases, each of which raises on
failure so the script exits non-zero:

1. setup: the card's name and power limit (nvidia-smi), then every CUDA
   source under src/repro_torch/kernels/csrc/ built with nvcc; the device
   spec (src/repro_torch/specs/h100-sxm.json) against the card: its SM
   count, L2 and shared-memory sizes as the card reports them, its launch
   and cluster-barrier costs measured beside the spec's (a `spec` line);
1b. energy: the energy model's three constants measured through NVML
   (ctypes on libnvidia-ml.so.1: the card idle with a live context, a
   2 GiB device-to-device copy_, an f32 GEMM with TF32 off, each window at
   least 1 s) beside the spec's, then one K1 and one K2 advance at 512^3
   x 8 steps, 7pt-var, each repeated for at least 1 s, with
   models.energy beside the joules NVML counted (an `energy` line);
2. K1 (the MWD kernel) against its plain PyTorch version on the card at a
   mid-size grid: the four paper ops and the custom mixed op aniso11, fused
   and per-row, a B=2 batch against a per-item loop, a grid that is not a
   multiple of D_w or N_F, n_steps=0, f32 (bitwise), bf16/fp16 with f32
   accumulation and bf16 with native accumulation; then an x width at
   which the kernel itself splits each tile over several CTAs (fewer than
   the largest cluster; coefficients staged at one op and read in place at
   the others), fused, per-row, batched and f64; the machine model's fit
   twin (models.mwd_smem_plan) against the kernel's own launch choice on
   every width up to the first that fits no more, f32 and f64, 40, 200 and
   512 columns, each refusal predicted, the instance's static shared
   memory equal to the twin's, no plan refused with the runtime's invalid
   argument (F3); and F1: ops.mwd(aniso11,
   plan="auto"), which the port once refused, against ops.naive with K1
   bitwise at the resolved plan;
2a. calibration: K1 alone by CUDA events at CALIBRATION_PLANS and
   CALIBRATION_SIZES, models.fit_k1 over them, and the fitted phase costs
   and residuals beside the spec's committed costs and theirs (a
   `calibration` line); the tune phase prices with the committed spec;
2b. the measured tuner: tune_one per paper op at 512^3 x 8 steps into the
   run's own plan registry (a temporary file), one `tune_plan` line per
   plan scored (the model's prediction beside the measured whole ops.mwd
   call), the winner no slower than the baseline MWDPlan() it scored
   first, the plan the model alone picks; then a second tune_one that
   must measure nothing;
3. the main path at the production grid: ops.mwd(plan="auto") at 512^3 for
   the four paper ops, 8 steps (each problem drawn on the card,
   random_problem), resolving the tune phase's measured entry,
   against ops.naive on the card, K1 against its plain version on the
   same inputs, K1's time by CUDA events beside its compulsory bound and
   the schedule's own traffic bound (models.mwd_schedule_bytes), the whole
   ops.mwd call at the tuned plan and at PR 15's dw8.nf2.fused in turns,
   the model's prediction for each, and a
   `config` line per op: cluster size, slab width, threads, dynamic
   shared memory per CTA, which coefficient streams are staged, ptxas
   registers and spills, and the cluster barriers per CTA and row times
   one barrier's cost measured alone;
4. serving: serve_stencil("7pt-var", 512^3, 8 steps, 4 requests,
   max_batch=2; the server draws its requests on the card) on the same registry (its
   batch-2 key, not tuned, resolves through the model), every response
   bitwise equal to its own sequential ops.mwd, with K1's launch count
   read around the serving run, and K1 against its plain version at the
   serving batch's shape (B=2, 512^3);
4b. ragged serving: serve_stencil over 512^3 and 448 x 480 x 496 with
   pad="pow2" (one 512^3 class; each batch of two holds one exact and one
   smaller member, so every batch runs the frozen-halo masked path) for
   7pt-var, 7pt-const (its 7pt-const+mask twin) and 25pt-const: 2 batches
   of 2, waste 0.1144, every response bitwise equal to ops.mwd on its own
   grid at the record's plan, K1 launched; a `ragged_serving` line per op
   (plan and source, waste, p50/p99, GLUP/s over the requests' own cells,
   one ragged launch split into building the masked members,
   ops.mwd_batched and the crop beside two exact 512^3 members at the same
   plan, peak memory); for each op K1 against its plain version on the
   padded pair as the server launches it (B=2, 512^3), its kernel_config
   equal to models.mwd_smem_plan; at 7pt-const K1 alone on the twin
   beside K1 on 7pt-const at two exact members, each against its
   compulsory bound; then K1 on
   aniso11+mask against its plain version at the mid-size grid's pow2
   class, fused, per-row and B=2;
4c. the soak: launch.soak (the reference's seeded mixed-size traffic,
   two ragged classes, two lanes) on the card, every response bitwise
   equal to its own ops.mwd, none dropped, the batched drain faster than
   one launch a request, and its report through soak_report.verdict with
   CI's thresholds (p99 <= 2500 ms, 0 dropped, throughput ratio >= 1.0),
   K1's launches read around the soak's serving run alone, and K1
   against its plain version on one padded batch of 4 a soak class
   (a `soak` line);
5. the baselines: K2 (the spatial sweep) and K3 (the ghost-zone pass)
   against their plain versions at the mid-size grid, at a grid that is
   not a multiple of bz/by and at a 200-wide one, for the four paper ops
   and aniso11 (bitwise in f32, f64, native bf16 and fp16; n_steps=0,
   t_block 1 to 4, a t_block that does not divide n_steps, x tiles that
   do not divide nx), K2 where its tiling has edges (a tile that divides
   neither ny nor nx, nx = 29, a chunk that does not divide nz, bz = 1,
   bz > nz, f64 at R = 4), and K3 at the
   25-point ops where its layout changes: t_block 6 (y sub-tiles), a block
   of 80 rows (y sub-tiles) and t_block 8 in f32 and f64 (a pass split
   into launches); then ops.spatial
   and ops.ghostzone at 512^3 x 8 steps (drawn on the card) with default
   parameters against
   ops.naive, K2 and K3 against their plain versions on the same inputs,
   their times by CUDA events beside their bounds (K2 also beside its tile
   bound, models.sweep_tile_bytes; K3 beside its window bound,
   models.fused_window_bytes), a `config` line per op for K2 (tile,
   chunk, threads, ring planes, copy path, L2 prefetch, shared memory,
   resident CTAs, instance, ptxas registers and spills) and for K3 (x
   tile, y tile,
   threads, planes a step, layout, launches per pass, shared memory,
   resident CTAs, coefficient streams, ptxas registers and spills), and
   F.conv3d in full f32 (TF32 off) as K2's library yardstick
   (7pt-const);
6. the grid-size sweep: launch.sweep.run_sweep over the four paper ops at
   SWEEP_SIZES^3, fused, 8 steps, into a temporary results directory,
   plans from the run's registry (measured at 512^3, the calibrated model
   elsewhere), then a second run_sweep that must measure nothing; a
   `sweep_point` line per point with ops.spatial (K2) timed beside it,
   ops.mwd against ops.naive at the smallest size, and the fit_ecm
   summary.
7. the differentiable path (kernels.adjoint): 7a, K1 on the adjoint op
   (ir.adjoint: negated taps, transported streams; 25 streams at the
   25-point ops) of the four paper ops, aniso11 and tests/test_adjoint.py's
   mixed op against its plain version at the mid-size grid, fused, per-row
   and B=2, bitwise in f32, each launch's kernel_config equal to
   models.mwd_smem_plan; 7b, ops.mwd_diff's gradients wrt cur, prev and the
   streams against torch.autograd through ops.naive at 64^3 x 4 steps
   within the reference's 8·(atol + rtol·max(|ref|, 1)), its forward (the
   1st-order stacked one too) bitwise equal to ops.mwd; 7c, at 512^3 x 8
   steps per paper op, ops.mwd_diff(plan="auto") (the forward plan phase
   2b measured, the vjp plan from the model) forward and forward +
   backward by CUDA events, the K1 launches of the first call, K1 alone on
   one adjoint advance beside its bound and models.k1_predict, the peak
   memory (25pt-const's flat between 8 and 32 steps), one forward +
   backward under torch.profiler (K1's device time, the other kernels',
   the device's idle share) (`diff` lines); 7d,
   launch.fit.run_fit on 7pt-var at 512^3 (`fit` line) and
   launch.fit.main's 10x gate at (8, 12, 10) (`fit_gate` line).
8. the distributed stepper (distributed.stepper) on a 2x2 mesh whose four
   shards all sit on the card: 8a, K1 against its plain version, bitwise,
   on shard-shaped blocks of the 512^3 grid (the extended block with the
   runtime interior of a corner shard and of an inner-edge shard, and
   each zone slab of the overlapped schedule) at the shard plan, each
   kernel_config equal to the fit twin; 8b, run_distributed(plan="auto")
   at 512^3 x 8 steps, t_block 2, per paper op, synchronous and
   overlapped, bitwise equal to each other and to ops.naive, and at
   7pt-var and 25pt-const compress=True within the reference's 5e-2 of
   naive and not equal to the exact run; 8c, per op the min of 3 turns by
   CUDA events of the whole call (both schedules), of one super-step's
   exchange alone, interior K1 launches and boundary K1 launches, and of
   single-device ops.mwd(plan="auto") on the same problem, with
   models.super_step_time on those terms, halo_bytes and the exchange's
   GB/s, K1 launches per call, peak memory and the device split of one
   overlapped call under torch.profiler (`distributed` lines); 8d,
   kernels.adjoint.distributed_vjp(plan="auto") at 256^3 x 4 steps for
   7pt-var and 25pt-var within op.tolerance("f32") of ops.mwd_diff's
   gradients of the same loss; 8e, ElasticStencilRun on 7pt-var at 512^3
   (4 steps on 4 shards, save, 2 on 2, save, 2 on 4) bitwise equal to an
   uninterrupted run and to ops.naive, each shard key tuned once before
   and no plan measured at a rebuild; 8f, the sweep's distributed leg at
   512^3 on 4 shards and the scaling lattice, then launch.scaling_gate's
   verdict, printed as a reading, not a check (its premise, an exchange
   on a link of its own, does not hold on one card).
9. the paper's benchmark harness (repro_torch.benchmarks.run) at its card
   sizes, every bench but the soak (4c runs it), its gates raising, in the
   run's registry: Fig. 4, Tables I/II with ops.mwd at the model's plan
   measured at 512^3 x 8, Figs. 8-15 (naive, K2, K3, K1 at the
   reference's dw8/dw16 and plan="auto" at 128^3-512^3 x 4), Figs. 16-18
   (the model at 1024^3 for every cluster size, then K1 alone at 512^3 x
   8 at each cluster size requested through stencil_mwd.prepare(cluster=)
   for the registry's plan and the reference's dw32.nf2, each launch
   bitwise equal to its plain version, its configuration the fit twin's,
   each refusal one the twin predicts), Fig. 19, the tuner, fused vs
   per-row at 512^3, tuned vs default at 512^3, smoke, the 19-point box op
   at 512^3, batched serving at 128^3, adjoint_fit and lm_substrate (one
   train step of the reduced llama3.2-1b, mamba2-130m and mixtral-8x7b); a
   `bench` line per CSV row and a `groupsize` line per op (7pt-const,
   25pt-var).
10. the LM substrate's training path at full width through its launcher
   (repro_torch.launch.train.main, random weights from seed 0, sequence
   4096, the repo's train_4k length): 10a llama3.2-1b (16 layers, d_model
   2048, 1.24 B parameters, bf16, AdamW) for 3 steps at batch 2 with a
   checkpoint at step 2, then a second run resumed from it (writing
   none) whose loss at step 2 equals the straight run's within 1e-3
   relative and whose end state (params, AdamW moments, step) equals the
   straight run's, leaf by leaf, within 1e-3 of each leaf's largest
   magnitude; 10b gemma3-1b (local window 512, qk-norm, tanh-gelu,
   head_dim 256, vocab 262144) for 2 steps at batch 2; 10c mamba2-130m
   (SSD, chunk 256) for 2 steps at batch 4; every loss finite; 10d
   llama3.2-1b at full width in float32 (the 10a weights widened):
   decode_step over 16 positions against forward's logits within 1e-3 of
   their largest magnitude. One `lm_train` line per config: parameters,
   tokens a step, step ms (median of the steps after the first) and
   tokens/s, peak memory, the FLOPs of a step (6 N tokens plus attention
   or SSD) and their time at the spec's bf16 peak, beside
   launch.roofline.model_flops and the FLOPs launch.dryrun.count_step
   counts for the same step on meta tensors (remat included), and, from
   one more step under torch.profiler, the device's idle share and its
   five costliest operations. No stencil kernel runs in this phase: the
   LM path's products are torch.matmul, as the reference leaves them to
   XLA.
11. the LM substrate's serving path at full width through its launcher
   (repro_torch.launch.serve.main, seed-0 weights placed by
   training.sharding.place on the card's mesh, numpy-seeded prompts,
   prefill_into_cache, a greedy decode loop): 11a llama3.2-1b, batch 8,
   prompt 128, 128 tokens; 11b gemma3-1b, batch 8, prompt 512, 128
   tokens (the local layers' 512-slot ring wraps); 11c mamba2-130m,
   batch 8, prompt 128, 128 tokens (its O(1) state). Each runs twice:
   the ids lie in [0, vocab) and repeat. Checks: prefill_into_cache's
   last logits at float32 over a 32-token prompt against forward's last
   position within 1e-3 of their largest magnitude; sharding.place of the
   parameters on the one-card mesh requests from the caching allocator
   exactly the bytes local_shape gives (its requested_bytes). One
   `lm_serve` line per config: prefill ms, decode ms a token (median of
   synchronized steps), tokens/s, peak memory, the decode step's bound
   (launch.roofline.analytic_hbm_bytes for the decode kind at this batch
   and cache length over the spec's HBM rate) and its share, and one
   more decode step under torch.profiler (idle share, five costliest
   operations). No stencil kernel runs in this phase either.
12. the distributed stepper across processes: ranks spawned with
   torch.multiprocessing (spawn) through repro_torch.distributed.process.
   launch, each on cuda:0 over gloo and a file store, each spawn under a
   join deadline (a rank that fails, or the deadline, kills the others
   and the script exits non-zero). 12a: 2 ranks of two mesh columns, a
   (2, 2) process mesh (z across ranks, y within each), 512^3 x 8 steps,
   t_block 2, plan="auto" from the run's registry, the four paper ops,
   synchronous and overlapped bitwise equal to each other and to
   ops.naive; compress=True at 7pt-var and 25pt-const within 1e-5 of the
   single-controller compressed run, its error against the reference's
   budget a reading; 12b: 4 ranks of one column, a 2x2 make_mesh (both
   axes across ranks, the z-y corners two hops), 256^3 x 4 for 7pt-var
   and 25pt-const, bitwise against ops.naive; 12c: distributed_vjp at
   256^3 x 4 across 2 ranks bitwise against the single-controller one,
   and a checkpoint written at world size 2 resumed at world size 4
   bitwise against the straight run; 12d: `distributed_mp` lines with the
   card's name and power limit: the super-step loop's ms per schedule
   with the gather timed apart, beside phase 8c's single-controller call
   and single-device ops.mwd; one super-step's exchange split into D2H,
   the gloo transfer and H2D; each rank's carrier bytes, checked equal to
   halo_bytes of its shards' cross-rank faces (exact and compressed);
   rank 0's device idle share in an overlapped call (torch.profiler);
   peak memory and K1 launches per rank. With two cards or more 12a's
   checks run again over NCCL, one card per rank; on one card the phase
   prints that this leg was not run, and why.
13. the sharded LM step across torch.distributed ranks (FSDP over
   'data', tensor parallelism over 'model', training.spmd): four ranks
   spawned by process.launch on cuda:0 over gloo under one join
   deadline, released once the one-process runs they are held against
   are done (the ranks start up meanwhile). 13a launch.train.main on every rank, the mesh plan_mesh
   gives four ranks, (1, 4): llama3.2-1b --full, bf16, batch 2 x 512,
   2 steps, the losses within 2e-2 relative of the same argv in one
   process; 13b the train step on a (2, 2) mesh, llama3.2-1b at full
   width cut to 1 layer, float32, batch 2 x 256: loss, grad_norm and
   the next loss within 1e-4 x max(1, |ref|) of the one-process step;
   13c 13b's state gathered whole on (2, 2) (sharding.gather), written by
   rank 0 and restored on (1, 4), bitwise equal gathered (each block the
   shape local_shape gives); 13d
   launch.serve.serve_lm on every rank, (1, 4): llama3.2-1b at full
   width cut to 4 of its 16 layers, bf16, batch 8, prompt 16, 8 tokens
   (the share of ids equal to one process recorded), then 1 layer,
   float32, 4 tokens, ids equal to one process. Before they are
   released the ranks load the card's libraries and kernels with reduced
   steps of their own and build their groups (a few ms on the card). Every rank's state bytes equal local_bytes, and the
   collective bytes each rank counts (training.spmd.COUNTER) equal the
   dry-run's count of the step (launch.dryrun.count_collectives) times
   the steps run. One `lm_sharded` line per run with the card's name and
   power limit: the mesh, ms a step and tokens/s beside one process,
   each rank's peak GB and state bytes, the bytes and calls by kind, the
   share of the step inside gloo and in staging, rank 0's device idle
   share and costliest operations (torch.profiler). 13e-13h split what
   13a-13d do not: 13e launch.train.main for mamba2-130m --full (24
   layers, Mamba2 over its heads on (1, 4)), bf16, batch 4 x 256, 2
   steps, losses within 2e-2 relative of one process, then serve_lm on
   (1, 4) in float32 at 4 layers (batch 8, prompt 8, 4 tokens), ids
   equal; 13f
   mixtral-8x7b at the published width cut to 1 layer (experts over
   'model', FSDP over 'data'), float32, batch 4 x 128, on (2, 2), its
   weights drawn leaf by leaf (sharding.init_blocks, timed beside the
   one process's whole-tree draw), loss, aux, grad_norm and the next
   loss within 1e-4 x max(1, |ref|) of one process, the share of routed
   assignments the capacity drops in one process printed (from the
   router's counts and moe.capacity); 13g jamba-1.5-large at the
   published width cut to its layer 0 (Mamba2 at d_inner 16384 and a
   dense FFN) with Adafactor, as 13f, its weights drawn on the card, and
   Adafactor's state after the second update (which reads back the
   first's) gathered whole within 1e-4 of each leaf's norm of one
   process's; 13h gemma3-1b at the published width, batch-1 decode on
   (4, 1) with the KV slots over 'data' (steps.make_decoder): 2 tokens
   from a seeded random cache of 32768 slots at length 30000, float32
   at 6 layers (ids equal, logits within 1e-4 of one process) and bf16
   at 13 of its 26 (the share of equal ids recorded), the last token
   profiled. No stencil kernel runs in this phase.

Before the last line come one `baseline` JSON line per (op, method) and a
JSON object with one entry per kernel (K1's launches from phases 4, 4b,
4c, 7, 8b, 9 and the ranks of 12; K2's and K3's from 5b and 9); the last
line is
{"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.

Bounds take the HBM rate and f32 peak of the device spec.

With --compare it only times K1 (at dw8.nf2), K2 and K3 per paper op at
512^3 x 8, and K1 at the calibration phase's plans and sizes, for the
checkout at OTHER_CHECKOUT and for this one in turns (other, this, this,
other), each in its own process that builds its own kernels, and prints
K1's phase costs fitted to each tree's times (this tree's models.fit_k1).
With --calibrate it runs phase 1's build, the energy phase, the fit twin
and K1 at every fused plan up to d_w 16 at 256^3 and 512^3, and writes
OUT_DIR/calibration.json, the measurements behind the spec's energy
constants and K1 phase costs, and OUT_DIR/h100-sxm.json, the spec with
them (its `source` names the card and power limit). With
--sweep-k3 it only times K3 per paper op at every tile plan that fits
(`sweep_fused`), the measurement behind its choice of x tile, threads,
layout and planes a step; with --sweep-k2 it only times K2 per paper op at
the tile plans of `k2_plans` and `k2_variants` (`sweep_sweep`), the
measurement behind its choice of tile, threads, chunk, loads ahead, L2
prefetch and instance.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

MID_GRID = (48, 64, 40)
ODD_GRID = (37, 53, 29)
WIDE_GRID = (20, 40, 200)
MAIN_GRID = (512, 512, 512)
MAIN_STEPS = 8
SERVE_OP = "7pt-var"
TIMING_REPS = 5
ENERGY_WINDOW_S = 1.0        # NVML energy counter windows at least this long
CALIBRATED_BY = "Measured by chip_smoke.py --calibrate"



class Failed(RuntimeError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def aniso11(ir):
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [ir.Tap(0, 0, 0, ir.array(0)),
            ir.Tap(-1, 0, 0, ir.array(1)), ir.Tap(1, 0, 0, ir.array(1)),
            ir.Tap(0, -1, 0, ir.array(2)), ir.Tap(0, 1, 0, ir.array(2))]
    taps += [ir.Tap(0, 0, s * d, ir.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return ir.StencilOp("aniso11", tuple(taps),
                        default_scalars=(0.08, 0.04, 0.02))


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def same(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def first_difference(got, want) -> str:
    """The first cell at which two lists of levels differ, and both values."""
    import torch
    for level, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            return f"level {level}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}"
        diff = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
        if bool(diff.any()):
            cell = tuple(int(i) for i in diff.nonzero()[0])
            return (f"level {level} first differs at {cell}: kernel "
                    f"{float(a[cell])!r}, plain {float(b[cell])!r}")
    return "no differing cell"


def chip():
    """The device spec the port prices against (src/repro_torch/specs/)."""
    from repro_torch.core import specs
    return specs.current_spec()


def bound(op, grid, n_steps, *, passes=1, outputs=2, batch=1, word=4):
    """Least time (ms) for the work: compulsory bytes vs f32 flops.

    Each of `passes` launches reads every input stream once and writes
    `outputs` grids: K1 is one pass writing both levels, K2 one pass per
    step writing one grid, K3 one pass per t_block steps writing two. The
    HBM rate and f32 peak are the device spec's data-sheet figures.
    """
    cells = batch * grid[0] * grid[1] * grid[2]
    inputs = 1 + (op.time_order == 2) + op.n_coeff_arrays
    t_bytes = passes * (inputs + outputs) * cells * word / chip().hbm_bw
    t_ops = op.flops_per_lup * cells * n_steps / chip().peak_flops_f32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps, setup=None):
    """Median ms of `fn` by CUDA events; `setup` runs untimed before each."""
    import torch
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Tally:
    """Largest kernel-vs-plain error seen across the checks, per kernel."""

    def __init__(self):
        self.max_abs_err = {"mwd": 0.0, "sweep": 0.0, "fused": 0.0}

    def record(self, kernel, got, want, what, tol=None) -> bool:
        """Hold a kernel's output levels against its plain version's.

        Without `tol` they must be bitwise equal, else within `tol` =
        (atol, rtol). Returns whether they were bitwise.
        """
        bitwise = all(same(a, b) for a, b in zip(got, want))
        err = max(max_err(a, b) for a, b in zip(got, want))
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if tol is None:
            check(bitwise, f"{what}: {kernel} kernel != plain version "
                           f"(max err {err:.3g}; "
                           f"{first_difference(got, want)})")
        else:
            atol, rtol = tol
            for a, b in zip(got, want):
                ok = ((a.double() - b.double()).abs()
                      <= atol + rtol * b.double().abs()).all()
                check(bool(ok), f"{what}: {kernel} kernel vs plain version "
                                f"beyond {tol}")
        return bitwise

    def kernel_vs_plain(self, spec, state, arrays, scalars, n_steps, *,
                        tol=None, **kw):
        """K1 and its plain version on identical padded inputs.

        Compares the full padded parity grids (`record`). Returns the
        kernel's cropped result, whether it was bitwise, and the launch
        configuration the kernel chose.
        """
        import torch
        from repro_torch.kernels import stencil_mwd as sm
        jk = sm.prepare(spec, state, arrays, scalars, n_steps, **kw)
        jp = sm.prepare(spec, state, arrays, scalars, n_steps, **kw)
        cfg = sm.kernel_config(jk) if jk.bufs is not None else None
        sm.run_kernel(jk)
        torch.cuda.synchronize()
        sm.run_plain(jp)
        torch.cuda.synchronize()
        bitwise = self.record("mwd", jk.bufs, jp.bufs,
                              f"{spec.name} {kw} {cfg}", tol)
        return sm.finish(jk), bitwise, cfg


def ptxas_table(build_log: str) -> dict:
    """Per kernel entry in an nvcc -Xptxas -v log: registers and spills."""
    table, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            table[name] = {"registers": None, "spill_stores": None,
                           "spill_loads": None}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                table[name]["spill_stores"] = int(m.group(1))
                table[name]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                table[name]["registers"] = int(m.group(1))
    return table


def phase_setup() -> dict:
    """Card, builds; returns the ptxas table of every built kernel."""
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log("card (nvidia-smi name, power.limit):")
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    built = _build.build_all()
    table = {}
    for name, b in built.items():
        log(f"built {name}: {b.path.name} nvcc {b.seconds:.1f} s")
        for fn, info in ptxas_table(b.log).items():
            table[fn] = info
            log(f"  ptxas {fn}: {info['registers']} registers, spills "
                f"{info['spill_stores']}/{info['spill_loads']} bytes")
    log(f"phase 1 setup: {time.perf_counter() - t0:.1f} s")
    return table


def phase_kernel_checks(tally: Tally, dev) -> None:
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    specs = list(st.SPECS.values()) + [aniso11(ir)]
    staged = {}                  # op: coefficients staged at WIDE_GRID
    for spec in specs:
        d_w = 12 if spec.radius == 3 else 8
        state, coeffs = st.make_problem(spec, MID_GRID, seed=1, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        kw = dict(d_w=d_w, n_f=2)
        fused, _, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 8,
                                            fused=True, **kw)
        row, _, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 8,
                                          fused=False, **kw)
        check(all(same(a, b) for a, b in zip(fused, row)),
              f"{spec.name}: fused != per-row")
        naive = ops.naive(spec, state, coeffs, 8)
        err = max(max_err(a, b) for a, b in zip(fused, naive))
        atol, rtol = spec.tolerance("f32")
        check(err <= atol + rtol * max(float(naive[0].abs().max()), 1.0),
              f"{spec.name}: kernel vs naive err {err:.3g}")
        # B=2: the batched launches against a per-item loop, both on K1
        other = st.make_problem(spec, MID_GRID, seed=2, device=dev)
        probs = [(state, coeffs), other]
        cur, prev = ops.mwd_batched(spec, [p[0] for p in probs],
                                    [p[1] for p in probs], 8, **kw)
        for i, (s_i, c_i) in enumerate(probs):
            one = ops.mwd(spec, s_i, c_i, 8, **kw)
            check(same(cur[i], one[0]) and same(prev[i], one[1]),
                  f"{spec.name}: batched != per-item loop")
        bstate = (torch.stack([p[0][0] for p in probs]),
                  torch.stack([p[0][1] for p in probs]))
        barr = (torch.stack([ir.split_coeffs(spec, p[1])[0] for p in probs])
                if spec.n_coeff_arrays else None)
        tally.kernel_vs_plain(spec, bstate, barr, scalars, 8, fused=True,
                              **kw)
        # several CTAs per tile: at WIDE_GRID the kernel splits x over 2-7
        # of them (a cluster trading halos at R < 4); fused, per-row, the
        # batch and f64, whose rings take more, narrower slabs
        ws, wc = st.make_problem(spec, WIDE_GRID, seed=7, device=dev)
        wa, wsc = ir.split_coeffs(spec, wc)
        clusters = []
        for fused in (True, False):
            _, _, cw = tally.kernel_vs_plain(spec, ws, wa, wsc, 4,
                                             fused=fused, **kw)
            clusters.append(cw["cluster"])
        if spec.n_coeff_arrays:
            staged[spec.name] = cw["stage"]
        other = st.make_problem(spec, WIDE_GRID, seed=9, device=dev)
        wb = (torch.stack([ws[0], other[0][0]]),
              torch.stack([ws[1], other[0][1]]))
        wba = (torch.stack([wa, ir.split_coeffs(spec, other[1])[0]])
               if spec.n_coeff_arrays else None)
        tally.kernel_vs_plain(spec, wb, wba, wsc, 4, fused=True, **kw)
        s64, c64 = st.make_problem(spec, WIDE_GRID, dtype="f64", seed=6,
                                   device=dev)
        a64, sc64 = ir.split_coeffs(spec, c64)
        _, _, c64cfg = tally.kernel_vs_plain(spec, s64, a64, sc64, 4,
                                             fused=True, **kw)
        clusters.append(c64cfg["cluster"])
        check(all(1 < c < 8 for c in clusters),
              f"{spec.name}: {WIDE_GRID} ran {clusters} CTAs per tile")
        # a grid no slab width, D_w or N_F divides
        os_, oc = st.make_problem(spec, ODD_GRID, seed=8, device=dev)
        oa, osc = ir.split_coeffs(spec, oc)
        tally.kernel_vs_plain(spec, os_, oa, osc, 5, fused=True, d_w=d_w,
                              n_f=4)
        # n_steps = 0: the identity, no launch
        before = sm.LAUNCHES.count
        zero = ops.mwd(spec, state, coeffs, 0, **kw)
        check(sm.LAUNCHES.count == before and same(zero[0], state[0]),
              f"{spec.name}: n_steps=0 is not the launch-free identity")
        # reduced precision: f32 accumulation, and bf16 native
        for dt, acc in (("bf16", torch.float32), ("fp16", torch.float32),
                        ("bf16", None)):
            rs, rc = st.make_problem(spec, MID_GRID, dtype=dt, seed=3,
                                     device=dev)
            ra, rsc = ir.split_coeffs(spec, rc)
            _, bitwise, _ = tally.kernel_vs_plain(
                spec, rs, ra, rsc, 8, fused=True, acc_dtype=acc,
                tol=spec.tolerance(dt), **kw)
            log(f"  {spec.name} {dt} acc={acc}: kernel vs plain "
                f"{'bitwise' if bitwise else 'within op.tolerance'}")
        log(f"  {spec.name}: f32 fused/per-row/batched/n_steps=0, "
            f"{WIDE_GRID} fused/per-row/B=2/f64 ({clusters} CTAs per tile, "
            f"coefficients {'staged' if cw['stage'] else 'in place'}) and "
            f"{ODD_GRID} bitwise vs plain version; kernel vs naive err "
            f"{err:.3g}")
    spec = st.SPECS["7pt-const"]
    state, coeffs = st.make_problem(spec, ODD_GRID, seed=4, device=dev)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    out, _, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 5,
                                      d_w=8, n_f=4, fused=True)
    naive = ops.naive(spec, state, coeffs, 5)
    check(all(same(a, b) for a, b in zip(out, naive)),
          "non-multiple grid: kernel != naive")
    log(f"  non-multiple grid {ODD_GRID}: bitwise vs plain and naive")
    check(set(staged.values()) == {0, 1},
          f"{WIDE_GRID} did not run both coefficient paths: {staged}")
    check_fit_twin(dev)
    check_f1(tally, dev)
    log(f"phase 2 kernel checks: {time.perf_counter() - t0:.1f} s, "
        f"max |kernel - plain| {tally.max_abs_err['mwd']:.3g}")


def probe_lib(dev):
    """K1's library with its cluster probe bound, and the current stream."""
    import ctypes
    import torch
    from repro_torch.kernels import stencil_mwd as sm
    lib = sm._mwd_lib()
    lib.mwd_cluster_probe.restype = ctypes.c_int
    lib.mwd_cluster_probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib, torch.cuda.current_stream(dev).cuda_stream


def barrier_us(cluster: int, n_clusters: int, threads: int, dev) -> float:
    """Microseconds per cluster barrier, timed with nothing between them."""
    lib, stream = probe_lib(dev)
    ms = []
    for iters in (200, 2200):
        def probe(iters=iters):
            check(lib.mwd_cluster_probe(cluster, n_clusters, threads, iters,
                                        dev.index, stream) == 0,
                  "cluster barrier probe failed to launch")
        probe()
        ms.append(cuda_ms(probe, TIMING_REPS))
    return (ms[1] - ms[0]) * 1e3 / 2000


def launch_us(dev, cluster: int = 8, threads: int = 256,
              n: int = 2000) -> float:
    """Microseconds per kernel launch: `n` launches of an empty kernel in
    clusters of `cluster` CTAs (K1's shape at 512 columns), issued back to
    back through the ctypes binding onto one stream, by CUDA events."""
    lib, stream = probe_lib(dev)

    def burst():
        for _ in range(n):
            check(lib.mwd_cluster_probe(cluster, 1, threads, 0, dev.index,
                                        stream) == 0,
                  "launch probe failed to launch")

    burst()
    return cuda_ms(burst, TIMING_REPS) * 1e3 / n


def k1_ms(spec, state, arrays, scalars, kw, n_steps=MAIN_STEPS) -> float:
    """K1 alone on one prepared job (median of TIMING_REPS, grids restored
    untimed between runs)."""
    from repro_torch.kernels import stencil_mwd as sm
    job = sm.prepare(spec, state, arrays, scalars, n_steps, **kw)
    saved = [b.clone() for b in job.bufs]

    def restore():
        for b, s in zip(job.bufs, saved):
            b.copy_(s)

    sm.run_kernel(job)                      # warm-up
    return cuda_ms(lambda: sm.run_kernel(job), TIMING_REPS, restore)


def phase_spec(dev, ptxas: dict) -> dict:
    """The device spec against the card: what the card reports of its SMs,
    threads, registers, L2 and shared memory must equal the spec's figures,
    and the registers ptxas gave each generic f32 and f64 K1 instance the
    K1 model's (models.MWD_REGISTERS); its launch and cluster-barrier costs
    are measured here beside the spec's."""
    import torch
    from repro_torch.core import models
    spec = chip()
    for (word, stage, hoist), regs in models.MWD_REGISTERS.items():
        name = {4: "ff", 8: "dd"}.get(word)
        got = [v["registers"] for k, v in ptxas.items()
               if name and f"mwd_row_kernelI{name}Lb{stage}ELi{hoist}ELi0EE"
               in k]
        check(not name or got == [regs],
              f"ptxas gave K1 (word {word}, stage {stage}, hoist {hoist}) "
              f"{got} registers, the model counts {regs}")
    props = torch.cuda.get_device_properties(dev)
    read = {"n_sm": props.multi_processor_count,
            "threads_sm": getattr(props, "max_threads_per_multi_processor",
                                  None),
            "regs_sm": getattr(props, "regs_per_multiprocessor", None),
            "l2_bytes": getattr(props, "L2_cache_size", None),
            "smem_block_bytes": getattr(props, "shared_memory_per_block_optin",
                                        None),
            "smem_sm_bytes": getattr(props, "shared_memory_per_multiprocessor",
                                     None)}
    for field, value in read.items():
        check(value is None or value == getattr(spec, field),
              f"the card reports {field} = {value}, the spec "
              f"{spec.name} says {getattr(spec, field)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60, check=True)
    clock_mhz = float(smi.stdout.strip().splitlines()[0])
    out = {"spec": spec.name, "card": read, "clocks_max_sm_mhz": clock_mhz,
           # 32 banks of 4 bytes per clock on every SM
           "smem_bw_at_max_clock": read["n_sm"] * 128 * clock_mhz * 1e6,
           "launch_us": launch_us(dev), "launch_us_spec": spec.launch_s * 1e6,
           "cluster_barrier_us": barrier_us(8, 16, 256, dev),
           "cluster_barrier_us_spec": spec.cluster_barrier_s * 1e6,
           "smem_bw_spec": spec.smem_bw}
    log("spec " + json.dumps(out))
    return out


class Nvml:
    """The card's energy counter and power draw through NVML (ctypes on
    libnvidia-ml.so.1, installed with the GPU's kernel module; no Python
    package)."""

    def __init__(self, dev):
        import ctypes
        import torch
        self.ct = ctypes
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        check(self.lib.nvmlInit_v2() == 0, "nvmlInit_v2 failed")
        self.handle = ctypes.c_void_p()
        uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
        rc = (self.lib.nvmlDeviceGetHandleByUUID(
            f"GPU-{uuid}".encode(), ctypes.byref(self.handle))
            if uuid is not None else -1)
        if rc != 0:
            rc = self.lib.nvmlDeviceGetHandleByIndex_v2(
                dev.index or 0, ctypes.byref(self.handle))
        check(rc == 0, f"NVML found no handle for the card ({rc})")

    def energy_j(self) -> float:
        """Joules the card has drawn since NVML began counting (it counts
        millijoules)."""
        mj = self.ct.c_ulonglong()
        check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, self.ct.byref(mj)) == 0,
            "nvmlDeviceGetTotalEnergyConsumption failed")
        return mj.value / 1e3

    def power_w(self) -> float:
        mw = self.ct.c_uint()
        check(self.lib.nvmlDeviceGetPowerUsage(
            self.handle, self.ct.byref(mw)) == 0,
            "nvmlDeviceGetPowerUsage failed")
        return mw.value / 1e3

    def window(self, fn, min_s: float = ENERGY_WINDOW_S) -> dict:
        """Run `fn` back to back for at least `min_s` seconds: the calls,
        the seconds and the joules the counter moved over the window."""
        import torch
        fn()                                    # warm-up, outside
        torch.cuda.synchronize()
        calls, e0, t0 = 0, self.energy_j(), time.perf_counter()
        while True:
            fn()
            calls += 1
            if calls % 4 == 0:
                torch.cuda.synchronize()
                if time.perf_counter() - t0 >= min_s:
                    break
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        return {"calls": calls, "s": t, "j": self.energy_j() - e0,
                "w_end": self.power_w()}


def measure_energy_constants(nvml: Nvml, dev) -> dict:
    """The energy model's three constants, measured on the card.

    Static draw: the card idle for ENERGY_WINDOW_S with a live context.
    Joules per HBM byte: a device-to-device copy_ of 2 GiB (read + written
    per call), less the static draw over the window. Joules per flop: an
    f32 GEMM of 8192^3 with TF32 off (2 n^3 flops a call, few bytes), less
    the static draw and its compulsory bytes at the per-byte figure. A
    calibration load, not a kernel of the port.
    """
    import torch
    torch.cuda.synchronize()
    time.sleep(0.5)
    e0, t0 = nvml.energy_j(), time.perf_counter()
    time.sleep(ENERGY_WINDOW_S)
    idle = {"s": time.perf_counter() - t0, "j": nvml.energy_j() - e0,
            "w_end": nvml.power_w()}
    static_w = idle["j"] / idle["s"]
    src = torch.empty(2 ** 29, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    src.fill_(1.0)
    copy = nvml.window(lambda: dst.copy_(src))
    copy_bytes = copy["calls"] * 2 * src.numel() * 4
    j_byte = (copy["j"] - static_w * copy["s"]) / copy_bytes
    del src, dst
    n = 8192
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(n, n, device=dev)
    b = torch.randn(n, n, device=dev)
    gemm = nvml.window(lambda: a @ b)
    torch.backends.cuda.matmul.allow_tf32 = allow
    del a, b
    torch.cuda.empty_cache()
    flops = gemm["calls"] * 2.0 * n ** 3
    gemm_bytes = gemm["calls"] * 3.0 * n * n * 4
    j_flop = (gemm["j"] - static_w * gemm["s"] - j_byte * gemm_bytes) / flops
    return {"static_power_w": static_w, "joules_per_hbm_byte": j_byte,
            "joules_per_flop": j_flop, "idle": idle, "copy": copy,
            "copy_tb_per_s": copy_bytes / copy["s"] / 1e12, "gemm": gemm,
            "gemm_tflop_per_s": flops / gemm["s"] / 1e12}


def phase_energy(dev, nvml: Nvml) -> dict:
    """The energy model against NVML: its three constants measured beside
    the spec's (an `energy` line), then one K1 and one K2 advance at 512^3
    x 8 steps, 7pt-var, each repeated for at least ENERGY_WINDOW_S, with
    models.energy (the spec's constants, the call's modeled HBM bytes and
    flops, the measured seconds) beside the joules NVML counted."""
    import torch
    from repro_torch.core import ir, models, traffic
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    spec_chip = chip()
    measured = measure_energy_constants(nvml, dev)
    fields = ("static_power_w", "joules_per_flop", "joules_per_hbm_byte")
    out = {"measured": measured,
           "spec": {f: getattr(spec_chip, f) for f in fields}}
    spec = st.SPECS["7pt-var"]
    state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0, device=dev)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    lups = math.prod(MAIN_GRID) * MAIN_STEPS
    flops = spec.flops_per_lup * lups
    k1 = dict(d_w=8, n_f=2, fused=True)
    job = sm.prepare(spec, state, arrays, scalars, MAIN_STEPS, **k1)
    runs = {
        "mwd": (lambda: sm.run_kernel(job),
                traffic.mwd_run_traffic(spec, MAIN_GRID, MAIN_STEPS,
                                        **k1)["bytes"]),
        "sweep": (lambda: ops.spatial(spec, state, coeffs, MAIN_STEPS),
                  traffic.spatial_pass_traffic(spec, MAIN_GRID, 8)["bytes"]
                  * MAIN_STEPS)}
    for kernel, (fn, hbm_bytes) in runs.items():
        w = nvml.window(fn)
        per_call = w["s"] / w["calls"]
        model = {which: models.energy(flops, hbm_bytes, per_call, c).total_j
                 for which, c in (("spec", spec_chip), ("measured",
                                  SimpleNamespace(**{f: measured[f]
                                                     for f in fields})))}
        nvml_j = w["j"] / w["calls"]
        out[kernel] = {"op": spec.name, "grid": list(MAIN_GRID),
                       "steps": MAIN_STEPS, "calls": w["calls"],
                       "ms_per_call": per_call * 1e3, "hbm_bytes": hbm_bytes,
                       "flops": flops, "nvml_j_per_call": nvml_j,
                       "model_j_per_call": model["spec"],
                       "model_j_measured_constants": model["measured"],
                       "model_over_nvml": model["spec"] / nvml_j}
    del job, state, coeffs, arrays
    torch.cuda.empty_cache()
    log("energy " + json.dumps(out))
    log(f"phase 1b energy: {time.perf_counter() - t0:.1f} s")
    return out


# the calibration phase's K1 plans per kind of op (d_w, n_f, fused) and
# sizes: the plans phase 2b scores most, at three grid sizes
CALIBRATION_PLANS = {
    1: ((8, 1, True), (8, 2, True), (8, 4, True), (14, 2, True),
        (16, 2, True), (8, 2, False)),
    4: ((8, 1, True), (8, 2, True), (8, 4, True), (16, 4, True),
        (8, 4, False))}
CALIBRATION_SIZES = (256, 512)


def k1_calibration_points(dev, plans=CALIBRATION_PLANS,
                          sizes=CALIBRATION_SIZES) -> list[dict]:
    """K1 alone by CUDA events (`k1_ms`: one prepared job, 8 steps, f32,
    median of TIMING_REPS) for each paper op at each plan and N^3 size,
    with the launch choice the kernel reports, on problems drawn on the
    device (`random_problem`; `make_problem` in a checkout without it)."""
    import torch
    from repro_torch.core import ir, models
    from repro_torch.core import stencils as st
    from repro_torch.kernels import stencil_mwd as sm
    draw = getattr(st, "random_problem", st.make_problem)
    points = []
    for name, spec in st.SPECS.items():
        for n in sizes:
            grid = (n, n, n)
            state, coeffs = draw(spec, grid, seed=0, device=dev)
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            for d_w, n_f, fused in plans[spec.radius]:
                if not models.smem_fits(spec, d_w, n_f, n):
                    continue
                kw = dict(d_w=d_w, n_f=n_f, fused=fused)
                job = sm.prepare(spec, state, arrays, scalars, MAIN_STEPS,
                                 **kw)
                cfg = sm.kernel_config(job)
                del job
                ms = k1_ms(spec, state, arrays, scalars, kw)
                points.append({"op": name, "grid": list(grid),
                               "steps": MAIN_STEPS, **kw, "k1_ms": ms,
                               "config": cfg})
            del state, coeffs, arrays
            torch.cuda.empty_cache()
    return points


def k1_fit_points(points: list[dict]) -> list[dict]:
    """models.fit_k1's inputs of measured K1 points, under the spec's model."""
    from repro_torch.core import models
    from repro_torch.core import stencils as st
    out = []
    for p in points:
        pred = models.k1_predict(st.SPECS[p["op"]], tuple(p["grid"]),
                                 p["d_w"], p["n_f"], p["steps"],
                                 fused=p["fused"])
        key = (f"{p['op']} {'x'.join(map(str, p['grid']))} dw{p['d_w']}."
               f"nf{p['n_f']}.{'fused' if p['fused'] else 'row'}")
        out.append(models.k1_fit_point(key, pred, p["k1_ms"] / 1e3))
    return out


def phase_calibration(dev) -> dict:
    """K1's phase costs against the spec: K1 at CALIBRATION_PLANS and
    CALIBRATION_SIZES (`k1_calibration_points`), models.fit_k1 over them,
    the fitted costs beside the spec's committed ones, and the residuals of
    both (a `calibration` line). The tune phase prices plans with the
    committed spec; this phase only checks it."""
    from repro_torch.core import models
    t0 = time.perf_counter()
    points = k1_calibration_points(dev)
    fit_pts = k1_fit_points(points)
    spec_chip = chip()
    committed = models.K1Calibration(
        costs_s={f: getattr(spec_chip, f) for f in models.K1_COSTS.values()},
        n_points=len(fit_pts), max_rel_err=0.0)
    refit = models.k1_residuals(fit_pts)
    spec_res = models.k1_residuals(fit_pts, committed)
    out = {"points": len(fit_pts), "fitted_s": refit["calibration"]
           ["costs_s"], "spec_s": committed.costs_s,
           "fitted_max_abs_rel_err": refit["max_abs_rel_err"],
           "fitted_mean_abs_rel_err": refit["mean_abs_rel_err"],
           "spec_max_abs_rel_err": spec_res["max_abs_rel_err"],
           "spec_mean_abs_rel_err": spec_res["mean_abs_rel_err"],
           "per_point": [{"key": a["key"], "measured_ms":
                          a["measured_s"] * 1e3,
                          "spec_model_ms": b["calibrated_s"] * 1e3,
                          "fitted_ms": a["calibrated_s"] * 1e3}
                         for a, b in zip(refit["per_point"],
                                         spec_res["per_point"])]}
    log("calibration " + json.dumps(out))
    log(f"phase 2a calibration: {time.perf_counter() - t0:.1f} s")
    return out


def check_fit_twin(dev) -> dict:
    """models.mwd_smem_plan, the Python twin of K1's launch choice, against
    the kernel's own (stencil_mwd.kernel_config): the four paper ops and
    aniso11, f32 and f64, 40, 200 and 512 columns, every d_w from 2R up to
    the first width at which no n_f in {1, 2, 4} fits. Where the twin says
    no fit, the kernel must refuse with E_SMEM (-5); where it fits, cluster,
    slab, staging, threads, shared memory and ring depths must be equal,
    and the instance's static shared memory (which choose() counts beside
    the rings) must be models.MWD_STATIC_SMEM. Where the twin counts no CTA
    per SM by the kernel's conservative per-SM count, the kernel either
    takes the same plan or refuses with E_CLUSTER (-4), never with the
    runtime's invalid argument; models.smem_fits excludes these plans.
    `moved` counts the cases whose plan differs from the one the rings
    alone would have chosen (the opt-in limit without the static bytes),
    where K1 refused plans before it counted them."""
    from repro_torch.core import ir, models
    from repro_torch.core import stencils as st
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    counts = {"equal": 0, "e_smem": 0, "per_sm_0_refused": 0,
              "per_sm_0_equal": 0, "moved": 0}
    rings_alone = dataclasses.replace(
        chip(), smem_block_bytes=chip().smem_block_bytes
        + models.MWD_STATIC_SMEM)
    refusals = set()
    keys = ("cluster", "slab", "stage", "threads", "smem_bytes", "depth",
            "cdepth")
    for spec in list(st.SPECS.values()) + [aniso11(ir)]:
        r = spec.radius
        for dt, word in (("f32", 4), ("f64", 8)):
            for nx in (40, 200, 512):
                grid = (2 * r + 4, 2 * r + 4, nx)
                state, coeffs = st.make_problem(spec, grid, dtype=dt, seed=0,
                                                device=dev)
                arrays, scalars = ir.split_coeffs(spec, coeffs)
                d_w = 2 * r
                while True:
                    twins = []
                    for n_f in (1, 2, 4):
                        if d_w % n_f:
                            continue
                        twin = models.mwd_smem_plan(spec, d_w, n_f, nx, word)
                        twins.append(twin)
                        counts["moved"] += twin != models.mwd_smem_plan(
                            spec, d_w, n_f, nx, word, rings_alone)
                        job = sm.prepare(spec, state, arrays, scalars, 2,
                                         d_w=d_w, n_f=n_f, fused=True)
                        what = f"{spec.name} {dt} nx={nx} d_w={d_w} n_f={n_f}"
                        try:
                            cfg, err = sm.kernel_config(job), ""
                        except RuntimeError as e:
                            cfg, err = None, str(e)
                        if twin is None:
                            check("(-5)" in err, f"{what}: the twin says no "
                                                 f"fit, the kernel {cfg or err}")
                            counts["e_smem"] += 1
                        elif cfg is None:
                            check(twin.per_sm == 0 and "(-4)" in err,
                                  f"{what}: twin {twin}, kernel {err}")
                            counts["per_sm_0_refused"] += 1
                            refusals.add(err)
                        else:
                            got = {k: cfg[k] for k in keys}
                            want = {k: getattr(twin, k) for k in keys}
                            check(got == want, f"{what}: kernel {got} != "
                                               f"twin {want}")
                            check(cfg["static_smem"]
                                  == models.MWD_STATIC_SMEM,
                                  f"{what}: the kernel counts "
                                  f"{cfg['static_smem']} static bytes, the "
                                  f"twin {models.MWD_STATIC_SMEM}")
                            counts["per_sm_0_equal" if twin.per_sm == 0
                                   else "equal"] += 1
                    if all(t is None for t in twins):
                        break
                    d_w += 2 * r
    log(f"  fit twin vs kernel_config: {json.dumps(counts)}, refusals "
        f"where the twin counts no CTA per SM: {sorted(refusals)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts


def check_f1(tally: Tally, dev) -> dict:
    """F1 on the card: ops.mwd(aniso11, plan="auto") runs (R = 3, which the
    old fixed dw8.nf2 refused), within op.tolerance of ops.naive, and K1 is
    bitwise against its plain version at the resolved plan."""
    from repro_torch.core import ir, registry
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    spec = aniso11(ir)
    state, coeffs = st.make_problem(spec, MID_GRID, seed=0, device=dev)
    plan, source = registry.resolve_plan(spec, MID_GRID, word_bytes=4)
    out = ops.mwd(spec, state, coeffs, MAIN_STEPS, plan="auto")
    naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
    err = max(max_err(a, b) for a, b in zip(out, naive))
    atol, rtol = spec.tolerance("f32")
    check(err <= atol + rtol * max(float(naive[0].abs().max()), 1.0),
          f"aniso11 plan='auto' vs naive err {err:.3g}")
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    tally.kernel_vs_plain(spec, state, arrays, scalars, MAIN_STEPS,
                          d_w=plan.d_w, n_f=plan.n_f, fused=plan.fused)
    f1 = {"op": spec.name, "grid": list(MID_GRID), "plan":
          f"dw{plan.d_w}.nf{plan.n_f}.{'fused' if plan.fused else 'row'}",
          "plan_source": source, "err_vs_naive": err}
    log("  F1 " + json.dumps(f1) + ": K1 bitwise vs plain")
    return f1


def phase_tune(dev) -> dict:
    """The measured tuner at the main path's size, into the run's registry.

    tune_one per paper op at 512^3 x 8 steps, f32, at most 12 plans, 3
    timed calls each: one `tune_plan` line per plan it scored (the model's
    predicted K1 time, the measured whole ops.mwd call), the winner, and
    the plan the model alone resolves. The baseline MWDPlan() is scored
    first and the winner must be no slower. A second tune_one on the same
    registry must measure nothing.
    """
    import torch
    from repro_torch.core import autotune, models, registry
    from repro_torch.core import stencils as st
    from repro_torch.core.mwd import MWDPlan
    from repro_torch.launch import tune
    t0 = time.perf_counter()
    reg = registry.default_registry()
    lups = MAIN_GRID[0] * MAIN_GRID[1] * MAIN_GRID[2] * MAIN_STEPS
    out = {}
    for name, spec in st.SPECS.items():
        rep = tune.tune_one(spec, MAIN_GRID, reg, max_evals=12, reps=3,
                            n_steps=MAIN_STEPS, device=dev)
        check(rep["source"] == "measured" and rep["measurements"] > 0,
              f"{name}: tune_one measured nothing: {rep}")
        first, first_score = rep["evaluated"][0]
        check(first == MWDPlan() and math.isfinite(first_score)
              and rep["score"] >= first_score,
              f"{name}: the winner {rep['plan']} scores below the baseline "
              f"{first} ({rep['score']} < {first_score})")
        for plan, score in rep["evaluated"]:
            fits = (autotune._plan_valid(spec, plan) and models.smem_fits(
                spec, plan.d_w, plan.n_f, MAIN_GRID[2]))
            pred = (models.k1_predict(spec, MAIN_GRID, plan.d_w, plan.n_f,
                                      MAIN_STEPS, fused=plan.fused)
                    if fits else None)
            log("tune_plan " + json.dumps({
                "op": name, "plan": tune.plan_name(plan),
                "model_ms": pred.t_total * 1e3 if pred else None,
                "model_terms_ms": {k: getattr(pred, f"t_{k}") * 1e3 for k in
                                   ("bytes", "flops", "phase", "launch")}
                if pred else None,
                "measured_ms": (lups / score / 1e6
                                if math.isfinite(score) else None),
                "winner": plan == rep["plan"]}))
        alone = autotune.autotune(spec, MAIN_GRID, d_w_cap=MAIN_GRID[1],
                                  n_steps=MAIN_STEPS).plan
        out[name] = {"plan": tune.plan_name(rep["plan"]),
                     "measured_ms": lups / rep["score"] / 1e6,
                     "baseline_ms": lups / first_score / 1e6,
                     "model_alone": tune.plan_name(alone),
                     "measurements": rep["measurements"],
                     "evals": rep["evals"], "seconds": rep["seconds"]}
        log(f"tune {name}: " + json.dumps(out[name]))
        torch.cuda.empty_cache()
    for name, spec in st.SPECS.items():
        again = tune.tune_one(spec, MAIN_GRID, reg, max_evals=12, reps=3,
                              n_steps=MAIN_STEPS, device=dev)
        check(again["source"] == "cached" and again["measurements"] == 0,
              f"{name}: the second tune_one measured {again}")
    log("  second tune_one: 0 measurements for every op")
    log(f"phase 2b tune: {time.perf_counter() - t0:.1f} s")
    return out


def phase_main_path(tally: Tally, dev, ptxas: dict) -> dict:
    import torch
    from repro_torch.core import ir, models, registry
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    rows = {}
    for name, spec in st.SPECS.items():
        t_gen = time.perf_counter()
        state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0, device=dev)
        t_gen = time.perf_counter() - t_gen
        plan, source = registry.resolve_plan(spec, MAIN_GRID, word_bytes=4)
        check(plan == ops.resolve_plan(spec, state, "auto")
              and source == "registry:measured",
              f"{name}: plan='auto' resolved {plan} from {source}, not the "
              f"tune phase's measured entry")
        sm.LAUNCHES.count = 0
        out = ops.mwd(spec, state, coeffs, MAIN_STEPS, plan="auto")
        torch.cuda.synchronize()
        launches = sm.LAUNCHES.count
        naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
        torch.cuda.synchronize()
        err = max(max_err(a, b) for a, b in zip(out, naive))
        bitwise_naive = all(same(a, b) for a, b in zip(out, naive))
        atol, rtol = spec.tolerance("f32")
        check(all(bool(torch.isfinite(a).all()) for a in out),
              f"{name}: non-finite output")
        check(err <= atol + rtol * max(float(naive[0].abs().max()), 1.0),
              f"{name}: ops.mwd vs ops.naive err {err:.3g} at 512^3")
        del out, naive
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        kw = dict(d_w=plan.d_w, n_f=plan.n_f, fused=plan.fused)
        tally.kernel_vs_plain(spec, state, arrays, scalars, MAIN_STEPS, **kw)
        # time K1 alone on one prepared job; restore its grids untimed
        job = sm.prepare(spec, state, arrays, scalars, MAIN_STEPS, **kw)
        saved = [b.clone() for b in job.bufs]

        def restore():
            for b, s in zip(job.bufs, saved):
                b.copy_(s)

        sm.run_kernel(job)                      # warm-up
        kernel_ms = cuda_ms(lambda: sm.run_kernel(job), TIMING_REPS, restore)
        plain_ms = cuda_ms(lambda: sm.run_plain(job), 1, restore)
        cfg = sm.kernel_config(job)
        star = sm.star_code(job)         # a star instance is built at hoist 0
        entry = next(v for k, v in ptxas.items()
                     if f"mwd_row_kernelIffLb{cfg['stage']}ELi"
                     f"{0 if star else cfg['hoist']}ELi{star}EE" in k)
        n_arr = spec.n_coeff_arrays
        staged = ("no coefficient stream" if n_arr == 0 else
                  f"all {n_arr} streams staged in shared memory"
                  if cfg["stage"] else
                  f"all {n_arr} streams read in place (L2/L1 prefetch)")
        # waves of resident clusters (of single CTAs where the tile's CTAs
        # run without a cluster) per row, and the barriers on each CTA
        per_row = [int(v) for v in sm.halo_schedule(job)[1].max(1)]
        unit = 1 if cfg["exchange"] else cfg["cluster"]
        waves = [math.ceil(int(job.comp.active[i].sum()) * unit
                           / cfg["max_active_clusters"])
                 for i in range(job.comp.n_rows)]
        probe = (barrier_us(cfg["cluster"], cfg["max_active_clusters"],
                            cfg["threads"], dev)
                 if any(per_row) else 0.0)
        barrier_ms = sum(w * n for w, n in zip(waves, per_row)) * probe / 1e3
        mode = ("a cluster trading x-halos" if cfg["exchange"] else
                "no cluster: no update reads a neighbour's halo")
        log(f"config {name}: {cfg['cluster']} CTAs per tile ({mode}), slab "
            f"{cfg['slab']} columns, {cfg['threads']} threads, "
            f"{cfg['smem_bytes']} bytes dynamic shared memory per CTA, "
            f"{cfg['max_active_clusters']} clusters resident, coefficients: "
            f"{staged}, {cfg['hoist']} groups' loads hoisted; ptxas "
            f"{entry['registers']} registers, spills "
            f"{entry['spill_stores']}/{entry['spill_loads']} bytes; cluster "
            f"barriers per CTA and row {per_row}, waves {waves}, "
            f"{probe:.3f} us each alone: {barrier_ms:.2f} ms of "
            f"{kernel_ms:.2f}")
        comp = job.comp
        del job, saved
        # the whole call at the tuned plan and at PR 15's fixed plan, in turns
        pr15 = dict(d_w=8, n_f=2, fused=True)
        calls = {"tuned": [], "dw8.nf2": []}
        for which in ("tuned", "dw8.nf2", "dw8.nf2", "tuned"):
            kw_call = kw if which == "tuned" else pr15
            calls[which].append(cuda_ms(lambda: ops.mwd(
                spec, state, coeffs, MAIN_STEPS, **kw_call), 3))
        mwd_ms = min(calls["tuned"])
        pr15_mwd_ms = min(calls["dw8.nf2"])
        pr15_kernel_ms = k1_ms(spec, state, arrays, scalars, pr15)
        predicted = {
            which: models.k1_predict(spec, MAIN_GRID, p["d_w"], p["n_f"],
                                     MAIN_STEPS, fused=p["fused"]).t_total
            * 1e3 for which, p in (("tuned", kw), ("dw8.nf2", pr15))}
        naive_ms = cuda_ms(lambda: ops.naive(spec, state, coeffs,
                                             MAIN_STEPS), 1)
        b_ms, b_by = bound(spec, MAIN_GRID, MAIN_STEPS)
        sched_ms = (models.mwd_schedule_bytes(spec, MAIN_GRID, plan.d_w,
                                              comp.n_rows)
                    / chip().hbm_bw * 1e3)
        lups = MAIN_GRID[0] * MAIN_GRID[1] * MAIN_GRID[2] * MAIN_STEPS
        row = {"op": name, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "plan": f"dw{plan.d_w}.nf{plan.n_f}."
                       f"{'fused' if plan.fused else 'row'}",
               "plan_source": source,
               "kernel_ms": kernel_ms, "glups": lups / kernel_ms / 1e6,
               "launches_per_call": launches, "bound_ms": b_ms,
               "bound_by": b_by, "roofline_share": b_ms / kernel_ms,
               "schedule_bound_ms": sched_ms,
               "schedule_share": sched_ms / kernel_ms,
               "barrier_ms": barrier_ms, "config": cfg,
               "plain_ms": plain_ms, "ops_mwd_ms": mwd_ms,
               "host_ms": mwd_ms - kernel_ms,
               "model_ms": predicted["tuned"],
               "dw8nf2_kernel_ms": pr15_kernel_ms,
               "dw8nf2_ops_mwd_ms": pr15_mwd_ms,
               "dw8nf2_model_ms": predicted["dw8.nf2"],
               "ops_mwd_ms_turns": calls,
               "tuned_vs_dw8nf2": mwd_ms / pr15_mwd_ms,
               "naive_ms": naive_ms, "err_vs_naive": err,
               "bitwise_vs_naive": bitwise_naive, "gen_s": t_gen}
        rows[name] = row
        log("main " + json.dumps(row))
        del state, coeffs, arrays
        torch.cuda.empty_cache()
    log("F2 tuned plan's ops.mwd over dw8.nf2.fused's, in turns: "
        + json.dumps({n: {"plan": r["plan"], "ratio": r["tuned_vs_dw8nf2"]}
                      for n, r in rows.items()}))
    log(f"phase 3 main path: {time.perf_counter() - t0:.1f} s")
    return rows


def phase_serving(tally: Tally, dev) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    sm.LAUNCHES.count = 0
    rep = serve.serve_stencil(SERVE_OP, MAIN_GRID, n_steps=MAIN_STEPS,
                              n_requests=4, max_batch=2, device=dev)
    launches = sm.LAUNCHES.count
    check(rep["served"] == 4, f"served {rep['served']}/4")
    check(rep["batch_sizes"] == [2, 2], f"batch sizes {rep['batch_sizes']}")
    check(launches > 0, "the serving run launched no K1 kernel")
    plans = {rec["rids"][0]: rec["plan"] for rec in rep["records"]}
    plan_of = {rid: plans[rec["rids"][0]] for rec in rep["records"]
               for rid in rec["rids"]}
    for req in rep["requests"]:
        want = ops.mwd(req.spec, req.state, req.coeffs, req.n_steps,
                       plan=plan_of[req.rid])
        got = rep["results"][req.rid]
        check(all(same(a, b) for a, b in zip(got, want)),
              f"request {req.rid}: batched response != sequential ops.mwd")
        check(bool(torch.isfinite(got[0]).all()), "non-finite response")
    # K1 against its plain version at the serving launch's own shape (B=2)
    from repro_torch.core import ir
    pair = rep["requests"][:2]
    spec = pair[0].spec
    bstate = tuple(torch.stack([r.state[i] for r in pair]) for i in (0, 1))
    barr = torch.stack([ir.split_coeffs(spec, r.coeffs)[0] for r in pair])
    plan = plan_of[pair[0].rid]
    tally.kernel_vs_plain(spec, bstate, barr, (), MAIN_STEPS, d_w=plan.d_w,
                          n_f=plan.n_f, fused=plan.fused)
    del bstate, barr
    summary = {"op": SERVE_OP, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "plan": f"dw{plan.d_w}.nf{plan.n_f}."
                       f"{'fused' if plan.fused else 'row'}",
               "plan_source": sorted({rec["plan_source"]
                                      for rec in rep["records"]}),
               "served": rep["served"], "batch_sizes": rep["batch_sizes"],
               "p50_ms": float(rep["p50_ms"]), "p99_ms": float(rep["p99_ms"]),
               "glups": rep["glups"], "wall_s": rep["wall_s"],
               "k1_launches": launches}
    log("serving " + json.dumps(summary))
    log(f"phase 4 serving: {time.perf_counter() - t0:.1f} s")
    return summary


# phase 4b: one pow2 class, 512^3; requests alternate the two shapes, so
# each batch of two holds one exact and one smaller member
RAGGED_OPS = ("7pt-var", "7pt-const", "25pt-const")
RAGGED_GRIDS = (MAIN_GRID, (448, 480, 496))
ANISO_SMALL = (40, 56, 36)      # aniso11's smaller member beside MID_GRID
SPLIT_REPS = 3
SOAK_GATE = dict(max_p99_ms=2500.0, max_dropped=0, min_throughput_ratio=1.0)


def ragged_waste() -> float:
    """The padding waste of one batch of RAGGED_GRIDS in MAIN_GRID's class."""
    real = sum(math.prod(g) for g in RAGGED_GRIDS)
    return (len(RAGGED_GRIDS) * math.prod(MAIN_GRID) - real) / real


def launch_split(spec, pair, plan) -> dict:
    """ms of one ragged launch of `pair` (one exact and one smaller
    member) split into building the masked members (`padding.pad_batch`),
    `ops.mwd_batched` and the crop, beside the whole `_launch_batch` of
    the ragged pair and of two exact members (median of SPLIT_REPS by
    CUDA events)."""
    import torch
    from repro_torch.core import padding
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ragged, exact = pair
    shapes = [tuple(r.state[0].shape) for r in ragged]
    held = {}

    def build():
        held["in"] = padding.pad_batch(spec, [r.state for r in ragged],
                                       [r.coeffs for r in ragged], MAIN_GRID)

    def run():
        mop, stacked, packed = held["in"]
        held["out"] = ops.mwd_batched(mop, stacked, packed, MAIN_STEPS,
                                      plan=plan)

    def crop():
        cur, prev = held["out"]
        held["crops"] = [padding.crop_state((cur[i], prev[i]), sh)
                         for i, sh in enumerate(shapes)]

    def launch(members):
        return lambda: serve._launch_batch(
            spec, [r.state for r in members], [r.coeffs for r in members],
            MAIN_STEPS, plan, MAIN_GRID)

    out = {"build_ms": cuda_ms(build, SPLIT_REPS,
                               lambda: held.pop("in", None))}
    out["mwd_batched_ms"] = cuda_ms(run, SPLIT_REPS,
                                    lambda: held.pop("out", None))
    out["crop_ms"] = cuda_ms(crop, SPLIT_REPS)
    held.clear()
    out["ragged_launch_ms"] = cuda_ms(launch(ragged), SPLIT_REPS)
    out["exact_launch_ms"] = cuda_ms(launch(exact), SPLIT_REPS)
    torch.cuda.empty_cache()
    return out


def padded_k1(tally: Tally, spec, pair, plan) -> dict:
    """K1 against its plain version on the ragged pair padded as
    `_launch_batch` pads it (B=2, 512^3, the launched op: the +mask twin or
    the op itself), its kernel_config against the fit twin. At 7pt-const
    also K1 alone on the twin beside K1 on 7pt-const at two exact 512^3
    members, each beside its compulsory bound."""
    import torch
    from repro_torch.core import ir, padding
    ragged, exact = pair
    mop, stacked, packed = padding.pad_batch(
        spec, [r.state for r in ragged], [r.coeffs for r in ragged],
        MAIN_GRID)
    arrays, scalars = ir.split_coeffs(mop, packed)
    kw = dict(d_w=plan.d_w, n_f=plan.n_f, fused=plan.fused)
    _, _, cfg = tally.kernel_vs_plain(mop, stacked, arrays, scalars,
                                      MAIN_STEPS, **kw)
    line = {"streams": mop.n_coeff_arrays,
            "padded_k1_vs_plain": "bitwise",
            "config": twin_line(mop, cfg, plan.d_w, plan.n_f, MAIN_GRID[2])}
    if spec.name != "7pt-const":
        return line
    line["twin_k1_ms"] = k1_ms(mop, stacked, arrays, scalars, kw)
    del stacked, arrays
    ex_state = tuple(torch.stack([r.state[i] for r in exact])
                     for i in (0, 1))
    _, ex_scalars = ir.split_coeffs(spec, exact[0].coeffs)
    line["op_k1_ms"] = k1_ms(spec, ex_state, None, ex_scalars, kw)
    for key, op in (("twin", mop), ("op", spec)):
        b, by = bound(op, MAIN_GRID, MAIN_STEPS, batch=2)
        line[f"{key}_bound_ms"], line[f"{key}_bound_by"] = b, by
        line[f"{key}_share"] = b / line[f"{key}_k1_ms"]
    return line


def check_aniso11_twin(tally: Tally, dev) -> None:
    """K1 on aniso11+mask (6 streams) against its plain version: a padded
    MID_GRID member and a smaller one in their pow2 class, fused, per-row
    and B=2, with kernel_config equal to the fit twin."""
    from repro_torch.core import ir, padding
    from repro_torch.core import stencils as st
    spec = aniso11(ir)
    cls = padding.POW2.padded_shape(MID_GRID)
    probs = [st.make_problem(spec, sh, seed=s, device=dev)
             for s, sh in enumerate((MID_GRID, ANISO_SMALL))]
    mop, stacked, packed = padding.pad_batch(
        spec, [p[0] for p in probs], [p[1] for p in probs], cls)
    arrays, scalars = ir.split_coeffs(mop, packed)
    one = (stacked[0][0], stacked[1][0])
    for fused in (True, False):
        _, _, cfg = tally.kernel_vs_plain(mop, one, arrays[0], scalars,
                                          MAIN_STEPS, d_w=12, n_f=2,
                                          fused=fused)
        line = twin_line(mop, cfg, 12, 2, cls[2])
    tally.kernel_vs_plain(mop, stacked, arrays, scalars, MAIN_STEPS, d_w=12,
                          n_f=2, fused=True)
    log(f"  {mop.name}: {mop.n_coeff_arrays} streams in class {cls}; "
        f"fused/per-row/B=2 bitwise vs plain; config = twin "
        f"{json.dumps(line)}")


def phase_ragged(tally: Tally, dev) -> dict:
    """4b: serve_stencil over RAGGED_GRIDS with pad="pow2" per RAGGED_OPS;
    returns the K1 launches of the serving runs."""
    import torch
    from repro_torch.core import padding
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    launches = 0
    for name in RAGGED_OPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        sm.LAUNCHES.count = 0
        rep = serve.serve_stencil(name, list(RAGGED_GRIDS),
                                  n_steps=MAIN_STEPS, n_requests=4,
                                  max_batch=2, pad="pow2", device=dev)
        n = sm.LAUNCHES.count
        peak = torch.cuda.max_memory_allocated()
        launches += n
        check(rep["served"] == 4, f"{name}: served {rep['served']}/4")
        check(rep["batch_sizes"] == [2, 2],
              f"{name}: batch sizes {rep['batch_sizes']}")
        check(rep["classes"] == {str(MAIN_GRID): 4},
              f"{name}: classes {rep['classes']}")
        check(abs(rep["padding_waste"] - ragged_waste()) < 1e-12,
              f"{name}: waste {rep['padding_waste']} != {ragged_waste()}")
        check(n > 0, f"{name}: the ragged serving run launched no K1 kernel")
        plan_of = {rid: rec["plan"] for rec in rep["records"]
                   for rid in rec["rids"]}
        for req in rep["requests"]:
            want = ops.mwd(req.spec, req.state, req.coeffs, req.n_steps,
                           plan=plan_of[req.rid])
            got = rep["results"][req.rid]
            check(tuple(got[0].shape) == tuple(req.state[0].shape),
                  f"{name} request {req.rid}: response not cropped")
            check(all(same(a, b) for a, b in zip(got, want)),
                  f"{name} request {req.rid}: ragged response != its own "
                  f"ops.mwd ({first_difference(got, want)})")
            check(bool(torch.isfinite(got[0]).all()), "non-finite response")
            del want
        spec = rep["requests"][0].spec
        first = rep["records"][0]
        plan = first["plan"]
        reqs = rep["requests"]
        pair = ([r for r in reqs if r.rid in first["rids"]],
                [r for r in reqs if tuple(r.state[0].shape) == MAIN_GRID])
        check(len(pair[1]) == 2 and len(pair[0]) == 2
              and {tuple(r.state[0].shape) for r in pair[0]}
              == set(RAGGED_GRIDS), f"{name}: batch {first['rids']} is not "
                                    "one exact and one smaller member")
        del rep["results"]
        summary = {
            "op": name, "twin": padding.masked_variant(spec).name,
            "grids": [list(g) for g in RAGGED_GRIDS],
            "class": list(MAIN_GRID), "steps": MAIN_STEPS,
            "plan": f"dw{plan.d_w}.nf{plan.n_f}."
                    f"{'fused' if plan.fused else 'row'}",
            "plan_source": sorted({rec["plan_source"]
                                   for rec in rep["records"]}),
            "batch_sizes": rep["batch_sizes"],
            "padding_waste": rep["padding_waste"],
            "p50_ms": float(rep["p50_ms"]), "p99_ms": float(rep["p99_ms"]),
            "glups": rep["glups"], "wall_s": rep["wall_s"],
            "k1_launches": n, "peak_gb": peak / 1e9,
            "peak_over_start_gb": (peak - start) / 1e9}
        summary.update(launch_split(spec, pair, plan))
        summary.update(padded_k1(tally, spec, pair, plan))
        log("ragged_serving " + json.dumps(summary))
        del rep, pair, reqs
        torch.cuda.empty_cache()
    check_aniso11_twin(tally, dev)
    log(f"phase 4b ragged serving: {time.perf_counter() - t0:.1f} s")
    return {"k1_launches": launches}


def phase_soak(tally: Tally, dev) -> dict:
    """4c: launch.soak on the card, its report through soak_report.verdict
    with CI's thresholds (SOAK_GATE), then K1 against its plain version on
    one padded batch of MAX_BATCH members per soak class; returns the K1
    launches of the soak's serving run (`run_mix`'s count: neither its
    warm-up, its checks nor the throughput contest)."""
    from repro_torch.core import ir, padding
    from repro_torch.core import stencils as st
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import serve, soak, soak_report
    t0 = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_soak_")
    try:
        path = os.path.join(out, "soak.json")
        events = soak.events_path(path)
        sm.LAUNCHES.count = 0
        report, problems, launches = soak.run_mix(dev, events)
        report = soak.finish(report, problems, path, events)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    fails = soak_report.verdict(report, **SOAK_GATE)
    check(not fails, "soak gate: " + "; ".join(fails))
    check(launches > 0, "the soak launched no K1 kernel")
    spec, plan = st.SPECS[soak.OP], soak.PLAN
    for cls, members in serve.padding_classes(problems, soak.LADDER).items():
        batch = members[:soak.MAX_BATCH]
        check(len(batch) == soak.MAX_BATCH
              and all(tuple(p[0][0].shape) != cls for p in batch),
              f"soak class {cls}: {len(batch)} members, not "
              f"{soak.MAX_BATCH} smaller ones")
        mop, stacked, packed = padding.pad_batch(
            spec, [p[0] for p in batch], [p[1] for p in batch], cls)
        arrays, scalars = ir.split_coeffs(mop, packed)
        tally.kernel_vs_plain(mop, stacked, arrays, scalars, soak.N_STEPS,
                              d_w=plan.d_w, n_f=plan.n_f, fused=plan.fused)
    line = {k: report[k] for k in (
        "op", "plan", "classes", "served", "dropped", "deadline_misses",
        "p50_ms", "p95_ms", "p99_ms", "throughput_ratio", "t_seq_s",
        "t_bat_s", "batch_sizes", "padding_waste", "wall_s")}
    line.update(gate=SOAK_GATE, k1_launches=launches,
                padded_k1_vs_plain="bitwise, one batch of "
                                   f"{soak.MAX_BATCH} a class")
    log("soak " + json.dumps(line))
    log(f"phase 4c soak: {time.perf_counter() - t0:.1f} s")
    return {"k1_launches": launches}


GHOSTZONE_DEFAULTS = dict(t_block=4, bz=16, by=16)   # ops.ghostzone's


def plain_spatial(spec, state, arrays, scalars, n_steps):
    """K2's plain version over a whole ops.spatial call."""
    from repro_torch.kernels import stencil_sweep as sw
    for _ in range(n_steps):
        state = sw.run_plain(spec, state, arrays, scalars)
    return state


def plain_ghostzone(spec, state, arrays, scalars, n_steps, t_block=4,
                    bz=16, by=16):
    """K3's plain version over a whole ops.ghostzone call (short last pass)."""
    from repro_torch.kernels import stencil_fused as fu
    for tb in fu.pass_lengths(n_steps, t_block):
        state = fu.run_plain(spec, state, arrays, scalars, tb, bz=bz, by=by)
    return state


def timed(fn):
    """Run `fn` once between CUDA events: (its result, ms)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_baselines_small(tally: Tally, dev) -> None:
    """K2 and K3 against their plain versions on small grids."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_fused as fu
    from repro_torch.kernels import stencil_sweep as sw
    t0 = time.perf_counter()
    # (grid, dtype, ops.spatial kwargs, ops.ghostzone kwargs, n_steps); K3
    # takes its own x tile, which divides none of these nx
    cases = [(MID_GRID, "f32", dict(bz=8), dict(t_block=3, bz=8, by=8), 5),
             (MID_GRID, "f32", {}, {}, MAIN_STEPS),
             (ODD_GRID, "f32", dict(bz=8), dict(t_block=3, bz=8, by=8), 5),
             (WIDE_GRID, "f32", {}, dict(t_block=1), 3),
             (MID_GRID, "f64", {}, dict(t_block=4), 5),
             (MID_GRID, "bf16", dict(bz=8), dict(t_block=3, bz=8, by=8), 5),
             (MID_GRID, "fp16", {}, dict(t_block=2), 5)]
    for spec in list(st.SPECS.values()) + [aniso11(ir)]:
        for grid, dt, kw_s, kw_g, n in cases:
            state, coeffs = st.make_problem(spec, grid, dtype=dt, seed=5,
                                            device=dev)
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            what = f"{spec.name} {grid} {dt} n_steps={n}"
            cfg_s = sw.kernel_config(spec, state[0], **kw_s)
            got_s = ops.spatial(spec, state, coeffs, n, **kw_s)
            want = plain_spatial(spec, state, arrays, scalars, n)
            torch.cuda.synchronize()
            tally.record("sweep", got_s, want, f"{what} {kw_s} {cfg_s}")
            kw = {**GHOSTZONE_DEFAULTS, **kw_g}
            cfg = fu.kernel_config(spec, state[0], kw["t_block"], bz=kw["bz"],
                                   by=kw["by"])
            got_g = ops.ghostzone(spec, state, coeffs, n, **kw_g)
            want = plain_ghostzone(spec, state, arrays, scalars, n, **kw)
            torch.cuda.synchronize()
            tally.record("fused", got_g, want, f"{what} {kw_g} {cfg}")
            if dt == "f32":
                naive = ops.naive(spec, state, coeffs, n)
                check(all(same(a, b) for a, b in zip(got_s, naive))
                      and all(same(a, b) for a, b in zip(got_g, naive)),
                      f"{what}: spatial/ghostzone != naive")
            log(f"  {what}: K2 {kw_s} bitwise vs plain "
                f"({sweep_plan_text(cfg_s)}), K3 {kw_g} bitwise vs plain "
                f"({fused_plan_text(cfg)})")
        # n_steps = 0: the identity, no launch
        before = (sw.LAUNCHES.count, fu.LAUNCHES.count)
        for fn in (ops.spatial, ops.ghostzone):
            zero = fn(spec, state, coeffs, 0)
            check(all(same(a, b) for a, b in zip(zero, state)),
                  f"{spec.name}: {fn.__name__} n_steps=0 is not the identity")
        check((sw.LAUNCHES.count, fu.LAUNCHES.count) == before,
              f"{spec.name}: n_steps=0 launched a kernel")
    # K2 where its tiling has edges: ODD_GRID (no tile divides ny or nx; nx
    # = 29 leaves rows unaligned), chunks that do not divide nz, bz = 1 and
    # bz > nz, the 200-wide grid, f64 at R = 4
    edges = set()
    for spec in list(st.SPECS.values()) + [aniso11(ir)]:
        for grid, dt, bz, n in ((ODD_GRID, "f32", 1, 2),
                                (ODD_GRID, "bf16", 3, 3),
                                (ODD_GRID, "f64", 64, 2),
                                (WIDE_GRID, "fp16", 5, 2),
                                (WIDE_GRID, "f64", 8, 2)):
            state, coeffs = st.make_problem(spec, grid, dtype=dt, seed=10,
                                            device=dev)
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            cfg = sw.kernel_config(spec, state[0], bz=bz)
            before = sw.LAUNCHES.count
            got = ops.spatial(spec, state, coeffs, n, bz=bz)
            want = plain_spatial(spec, state, arrays, scalars, n)
            torch.cuda.synchronize()
            what = f"{spec.name} {grid} {dt} bz={bz} n_steps={n}"
            tally.record("sweep", got, want, f"{what} {cfg}")
            check(sw.LAUNCHES.count - before == n and cfg["chunk"] % bz == 0,
                  f"{what}: {sw.LAUNCHES.count - before} K2 launches, {cfg}")
            edges |= {k for k, hit in (
                ("ty divides no ny", grid[1] % cfg["ty"]),
                ("tx divides no nx", grid[2] % cfg["tx"]),
                ("unaligned rows", grid[2] * state[0].element_size() % 16),
                ("chunk divides no nz", grid[0] % cfg["chunk"]),
                ("bz = 1", bz == 1), ("bz > nz", bz > grid[0]),
                ("f64 at R = 4", dt == "f64" and spec.radius == 4)) if hit}
            log(f"  {what}: K2 bitwise vs plain ({sweep_plan_text(cfg)})")
    check(len(edges) == 7, f"K2's tiling edges not all run: {edges}")
    # K3 where no layout holds a block of by rows (y sub-tiles) or a pass
    # in one launch (launches of fewer steps)
    for spec in (st.SPECS["25pt-const"], st.SPECS["25pt-var"]):
        for dt, kw_g, n, sub, split in (
                ("f32", dict(t_block=6), 7, True, False),
                ("f32", dict(by=80), 5, True, False),
                ("f32", dict(t_block=8), 8, True, True),
                ("f64", dict(t_block=8), 8, True, True)):
            state, coeffs = st.make_problem(spec, MID_GRID, dtype=dt, seed=6,
                                            device=dev)
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            kw = {**GHOSTZONE_DEFAULTS, **kw_g}
            cfg = fu.kernel_config(spec, state[0], kw["t_block"], bz=kw["bz"],
                                   by=kw["by"])
            check((cfg["ty"] < kw["by"]) == sub
                  and (len(cfg["launches"]) > 1) == split,
                  f"{spec.name} {dt} {kw_g}: unexpected K3 plan {cfg}")
            before = fu.LAUNCHES.count
            got_g = ops.ghostzone(spec, state, coeffs, n, **kw_g)
            want = plain_ghostzone(spec, state, arrays, scalars, n, **kw)
            torch.cuda.synchronize()
            launched = fu.LAUNCHES.count - before
            what = f"{spec.name} {MID_GRID} {dt} n_steps={n} {kw_g}"
            tally.record("fused", got_g, want, f"{what} {cfg}")
            check(launched == sum(len(fu.launch_steps(
                spec, tb, kw["by"], MID_GRID[2], state[0].element_size()))
                for tb in fu.pass_lengths(n, kw["t_block"])),
                f"{what}: {launched} K3 launches")
            log(f"  {what}: K3 bitwise vs plain, {launched} launches "
                f"({fused_plan_text(cfg)})")
    log(f"phase 5a baselines, small grids: {time.perf_counter() - t0:.1f} s,"
        f" max |kernel - plain| K2 {tally.max_abs_err['sweep']:.3g}"
        f" K3 {tally.max_abs_err['fused']:.3g}")


def library_conv3d(spec, state, scalars, dev) -> dict:
    """F.conv3d as one step of 7pt-const, timed beside one K2 launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import stencil_sweep as sw
    c0, c1 = scalars
    w = torch.zeros((1, 1, 3, 3, 3), dtype=state[0].dtype, device=dev)
    w[0, 0, 1, 1, 1] = c0
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = c1
    x = state[0][None, None]
    prior = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # full f32, as K2 computes
    try:
        lib_out = F.conv3d(x, w)                           # warm-up
        library_ms = cuda_ms(lambda: F.conv3d(x, w), TIMING_REPS)
    finally:
        torch.backends.cudnn.allow_tf32 = prior
    log(f"library F.conv3d timed in full f32 (cudnn.allow_tf32 False, "
        f"restored to {prior}): {library_ms:.3f} ms")
    k2 = sw.run_kernel(spec, state, None, scalars)         # warm-up
    step_ms = cuda_ms(lambda: sw.run_kernel(spec, state, None, scalars),
                      TIMING_REPS)
    err = max_err(lib_out[0, 0], k2[0][1:-1, 1:-1, 1:-1])
    return {"library_ms": library_ms, "k2_step_ms": step_ms,
            "library_err_vs_k2": err,
            "library_precision": "f32 (cudnn.allow_tf32 False)"}


def fused_plan_text(cfg: dict) -> str:
    """K3's plan from stencil_fused.kernel_config, in words."""
    return (f"bx {cfg['bx']}, ty {cfg['ty']}, {cfg['threads']} threads, "
            f"{cfg['planes']} planes a step, layout {cfg['layout']}, "
            f"launches of {cfg['launches']} steps")


def sweep_plan_text(cfg: dict) -> str:
    """K2's plan from stencil_sweep.kernel_config, in words."""
    return (f"tile {cfg['ty']} x {cfg['tx']}, chunk {cfg['chunk']} planes, "
            f"{cfg['threads']} threads, ring of {cfg['ring_planes']} planes "
            f"by {cfg['copy']}, L2 prefetch {cfg['prefetch']} planes ahead, "
            f"V={cfg['cells']} H={cfg['hoist']}")


def sweep_config_line(spec, cur, ptxas: dict) -> dict:
    """K2's launch configuration for ops.spatial's default bz on `cur`, its
    ptxas report, and its tile bound (models.sweep_tile_bytes) over
    MAIN_STEPS steps."""
    from repro_torch.core import models
    from repro_torch.kernels import stencil_sweep as sw
    cfg = sw.kernel_config(spec, cur)
    ring = int(cfg["copy"] == "cp.async")
    entry = next(v for k, v in ptxas.items()
                 if f"sweep_kernelIfLb{ring}ELi{cfg['hoist']}E" in k)
    tile = models.sweep_tile_bytes(spec, cur.shape, 8, cur.element_size())
    n_arr = spec.n_coeff_arrays
    streams = ("no coefficient stream" if n_arr == 0 else
               f"all {n_arr} streams read at the cell")
    log(f"config {spec.name} K2: {sweep_plan_text(cfg)}, {cfg['ahead']} "
        f"planes loaded ahead, {cfg['smem_bytes']} bytes dynamic shared "
        f"memory per CTA, {cfg['resident']} CTAs resident per SM, "
        f"{cfg['ctas']} CTAs per step, coefficients: {streams}; ptxas "
        f"{entry['registers']} registers, spills {entry['spill_stores']}/"
        f"{entry['spill_loads']} bytes")
    return {"config": cfg, "registers": entry["registers"],
            "spill_stores": entry["spill_stores"],
            "spill_loads": entry["spill_loads"],
            "tile_bound_ms": tile * MAIN_STEPS / chip().hbm_bw * 1e3}


def fused_config_line(spec, cur, ptxas: dict) -> dict:
    """K3's launch configuration for ops.ghostzone's defaults on `cur`, its
    ptxas report, and its window bound (models.fused_window_bytes) summed
    over the passes of MAIN_STEPS."""
    from repro_torch.core import models
    from repro_torch.kernels import stencil_fused as fu
    kw = {k: GHOSTZONE_DEFAULTS[k] for k in ("bz", "by")}
    cfg = fu.kernel_config(spec, cur, GHOSTZONE_DEFAULTS["t_block"], **kw)
    layout = int(cfg["layout"] == "cur-in-place")
    entry = next(v for k, v in ptxas.items()
                 if f"fused_kernelIfLb{layout}ELi{cfg['hoist']}ELi"
                    f"{cfg['planes']}E" in k)
    check(len(cfg["launches"]) == 1,
          f"{spec.name}: K3 splits a pass at the defaults: {cfg}")
    window = sum(models.fused_window_bytes(spec, cur.shape, tb, kw["bz"],
                                           kw["by"], cur.element_size())
                 for tb in fu.pass_lengths(MAIN_STEPS,
                                           GHOSTZONE_DEFAULTS["t_block"]))
    n_arr = spec.n_coeff_arrays
    streams = ("no coefficient stream" if n_arr == 0 else
               f"all {n_arr} streams read in place")
    log(f"config {spec.name} K3: {fused_plan_text(cfg)}, "
        f"{cfg['smem_bytes']} bytes dynamic shared "
        f"memory per CTA, {cfg['resident']} CTAs resident per SM, "
        f"{cfg['ctas']} CTAs per pass, coefficients: {streams}; ptxas "
        f"{entry['registers']} registers, spills {entry['spill_stores']}/"
        f"{entry['spill_loads']} bytes")
    return {"config": cfg, "registers": entry["registers"],
            "spill_stores": entry["spill_stores"],
            "window_bound_ms": window / chip().hbm_bw * 1e3}


def phase_baselines_main(tally: Tally, dev,
                         ptxas: dict) -> tuple[dict, dict, dict]:
    """ops.spatial / ops.ghostzone at 512^3 against naive, plain, bound."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_fused as fu
    from repro_torch.kernels import stencil_sweep as sw
    t0 = time.perf_counter()
    rows, launches, library = {}, {"sweep": 0, "fused": 0}, {}
    tb = GHOSTZONE_DEFAULTS["t_block"]
    methods = (
        ("spatial", "sweep", sw, plain_spatial,
         dict(passes=MAIN_STEPS, outputs=1)),
        ("ghostzone", "fused", fu, plain_ghostzone,
         dict(passes=-(-MAIN_STEPS // tb), outputs=2)))
    for name, spec in st.SPECS.items():
        state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
        # timed on a second run: the first grows the caching allocator
        naive_ms = cuda_ms(
            lambda: ops.naive(spec, state, coeffs, MAIN_STEPS), 1)
        atol, rtol = spec.tolerance("f32")
        limit = atol + rtol * max(float(naive[0].abs().max()), 1.0)
        for method, kernel, mod, plain, work in methods:
            fn = getattr(ops, method)
            mod.LAUNCHES.count = 0
            out = fn(spec, state, coeffs, MAIN_STEPS)
            torch.cuda.synchronize()
            n_launch = mod.LAUNCHES.count
            launches[kernel] += n_launch
            check(n_launch > 0, f"{name}: ops.{method} launched no {kernel} "
                                "kernel")
            check(all(bool(torch.isfinite(a).all()) for a in out),
                  f"{name}: ops.{method} non-finite output")
            err = max(max_err(a, b) for a, b in zip(out, naive))
            check(err <= limit, f"{name}: ops.{method} vs ops.naive err "
                                f"{err:.3g} at 512^3")
            bitwise_naive = all(same(a, b) for a, b in zip(out, naive))
            want, plain_ms = timed(
                lambda: plain(spec, state, arrays, scalars, MAIN_STEPS))
            bit_plain = tally.record(kernel, out, want,
                                     f"{name} 512^3 ops.{method}")
            del out, want
            kernel_ms = cuda_ms(
                lambda: fn(spec, state, coeffs, MAIN_STEPS), TIMING_REPS)
            b_ms, b_by = bound(spec, MAIN_GRID, MAIN_STEPS, **work)
            lups = MAIN_GRID[0] * MAIN_GRID[1] * MAIN_GRID[2] * MAIN_STEPS
            row = {"op": name, "method": method, "kernel": kernel,
                   "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
                   "kernel_ms": kernel_ms, "glups": lups / kernel_ms / 1e6,
                   "launches_per_call": n_launch, "bound_ms": b_ms,
                   "bound_by": b_by, "roofline_share": b_ms / kernel_ms,
                   "plain_ms": plain_ms, "naive_ms": naive_ms,
                   "err_vs_naive": err, "bitwise_vs_naive": bitwise_naive,
                   "bitwise_vs_plain": bit_plain}
            if name == "7pt-const" and method == "spatial":
                library = library_conv3d(spec, state, scalars, dev)
                row.update(library)
            if method == "spatial":
                row.update(sweep_config_line(spec, state[0], ptxas))
                row["tile_share"] = row["tile_bound_ms"] / kernel_ms
            if method == "ghostzone":
                row.update(fused_config_line(spec, state[0], ptxas))
                row["window_share"] = row["window_bound_ms"] / kernel_ms
            rows[(name, method)] = row
            log("baseline " + json.dumps(row))
        del state, coeffs, arrays, naive
        torch.cuda.empty_cache()
    log(f"phase 5b baselines at {MAIN_GRID}: "
        f"{time.perf_counter() - t0:.1f} s")
    return rows, launches, library


SWEEP_SIZES = (128, 256, 384, 512, 768)


def phase_sweep(dev) -> dict:
    """The grid-size sweep through its entry point: run_sweep over the four
    paper ops at SWEEP_SIZES^3, fused, 8 steps, f32, into a temporary
    results directory, plans resolved through the run's own registry (the
    tune phase's measured entries at 512^3, the calibrated model
    elsewhere); a second run_sweep must measure nothing. Beside every
    point, ops.spatial (K2) at the same grid by CUDA events (a `sweep_point`
    line); each point's ops.mwd against ops.naive at the smallest size; the
    fit_ecm summary."""
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.launch import sweep
    t0 = time.perf_counter()
    grids = sweep.ladder(SWEEP_SIZES)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        path = os.path.join(out_dir, "sweep.json")
        first = sweep.run_sweep(list(st.SPECS.values()), grids,
                                n_steps=MAIN_STEPS, results_path=path,
                                verbose=False, device=dev.type)
        check(first["n_measured"] == len(grids) * len(st.SPECS),
              f"the sweep measured {first['n_measured']} points")
        again = sweep.run_sweep(list(st.SPECS.values()), grids,
                                n_steps=MAIN_STEPS, results_path=path,
                                verbose=False, device=dev.type)
        check(again["n_measured"] == 0 and again["n_skipped"]
              == first["n_measured"],
              f"the second run_sweep measured {again['n_measured']}")
        check(os.path.exists(first.get("calibration_path", "")),
              "the sweep saved no ECM calibration")
        points = first["points"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rows = []
    for name, spec in st.SPECS.items():
        for grid in grids:
            p = next(v for v in points.values() if v["stencil"] == name
                     and tuple(v["grid"]) == grid)
            state, coeffs = st.random_problem(spec, grid, seed=0, device=dev)
            if grid == grids[0]:
                pl = p["plan"]
                got = ops.mwd(spec, state, coeffs, MAIN_STEPS, d_w=pl["d_w"],
                              n_f=pl["n_f"], fused=pl["fused"])
                naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
                err = max(max_err(a, b) for a, b in zip(got, naive))
                atol, rtol = spec.tolerance("f32")
                check(err <= atol + rtol * max(float(naive[0].abs().max()),
                                               1.0),
                      f"sweep {name} {grid}: ops.mwd vs naive err {err:.3g}")
                del got, naive
            ops.spatial(spec, state, coeffs, MAIN_STEPS)        # warm-up
            k2_ms = cuda_ms(lambda: ops.spatial(spec, state, coeffs,
                                                MAIN_STEPS), 3)
            m = p["measured"]
            row = {"op": name, "grid": list(grid),
                   "plan": f"dw{p['plan']['d_w']}.nf{p['plan']['n_f']}",
                   "plan_source": p["plan_source"],
                   "ops_mwd_ms": m["t_s"] * 1e3,
                   "k1_ms": m["k1_t_s"] * 1e3,
                   "k1_model_ms": p["model"]["k1"]["t_s"] * 1e3,
                   "k2_ms": k2_ms, "k1_over_k2": m["k1_t_s"] * 1e3 / k2_ms,
                   "glups": m["glups"], "b_per_lup": p["traffic"]
                   ["b_per_lup"], "device": p["device"]}
            rows.append(row)
            log("sweep_point " + json.dumps(row))
            del state, coeffs
            torch.cuda.empty_cache()
    summary = sweep.calibration_summary(points.values())
    log(f"sweep fit_ecm: {summary}")
    log(f"phase 6 sweep: {time.perf_counter() - t0:.1f} s")
    return {"rows": rows, "fit_ecm": summary}


def mixed(ir):
    """tests/test_adjoint.py's op: const and array taps in one 2nd-order
    operator with a const time-recurrence scale."""
    return ir.StencilOp(
        "adj-mixed",
        (ir.Tap(0, 0, 0, ir.const(1)),
         ir.Tap(-1, 0, 0, ir.array(0)), ir.Tap(1, 0, 0, ir.array(0)),
         ir.Tap(0, -1, 0, ir.array(1)), ir.Tap(0, 1, 0, ir.array(1)),
         ir.Tap(0, 0, -1, ir.const(2)), ir.Tap(0, 0, 1, ir.const(2))),
        time_order=2, scale=ir.const(0),
        default_scalars=(0.21, -0.53, 0.11), coeff_scale=0.08)


GRAD_GRID = (64, 64, 64)
GRAD_STEPS = 4
FLAT_STEPS = (8, 32)
FIT_STEPS = 3
TWIN_KEYS = ("cluster", "slab", "stage", "threads", "smem_bytes", "depth",
             "cdepth")


def twin_line(spec, cfg, d_w, n_f, nx) -> dict:
    """A K1 launch's configuration beside the fit twin's, which must be
    equal."""
    from repro_torch.core import models
    twin = models.mwd_smem_plan(spec, d_w, n_f, nx)
    check(twin is not None, f"{spec.name}: the twin finds no fit at d_w="
                            f"{d_w}, n_f={n_f}, nx={nx}")
    got = {k: cfg[k] for k in TWIN_KEYS}
    want = {k: getattr(twin, k) for k in TWIN_KEYS}
    check(got == want, f"{spec.name} d_w={d_w} n_f={n_f}: kernel_config "
                       f"{got} != twin {want}")
    return dict(got, hoist=cfg["hoist"], exchange=cfg["exchange"])


def check_adjoint_k1(tally: Tally, dev) -> None:
    """7a: K1 on the adjoint op of each paper op, aniso11 and adj-mixed,
    with the streams `map_coeffs` transports, against its plain version at
    MID_GRID: fused, per-row and B=2, bitwise in f32; each launch's
    kernel_config equal to models.mwd_smem_plan."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    for spec in list(st.SPECS.values()) + [aniso11(ir), mixed(ir)]:
        adj = ir.adjoint(spec)
        d_w = 12 if spec.radius == 3 else 8
        probs = [st.make_problem(spec, MID_GRID, seed=s, device=dev)
                 for s in (11, 12)]
        state, coeffs = probs[0]
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        adj_arrays, adj_scalars = adj.map_coeffs(arrays, scalars)
        cfgs = []
        for fused in (True, False):
            _, _, cfg = tally.kernel_vs_plain(
                adj.op, state, adj_arrays, adj_scalars, MAIN_STEPS, d_w=d_w,
                n_f=2, fused=fused)
            cfgs.append(cfg)
        bstate = tuple(torch.stack([p[0][i] for p in probs]) for i in (0, 1))
        barr = None
        if spec.n_coeff_arrays:
            barr = torch.stack([ir.split_coeffs(spec, p[1])[0]
                                for p in probs])
        badj, _ = adj.map_coeffs(barr, scalars)
        tally.kernel_vs_plain(adj.op, bstate, badj, adj_scalars, MAIN_STEPS,
                              d_w=d_w, n_f=2, fused=True)
        line = twin_line(adj.op, cfgs[0], d_w, 2, MID_GRID[2])
        check(cfgs[1] == cfgs[0], f"{adj.op.name}: per-row config differs")
        log(f"  adjoint {adj.op.name}: {adj.op.n_coeff_arrays} streams, "
            f"{len(adj.op.groups)} groups, order {adj.op.time_order}, scale "
            f"{adj.op.scale}; fused/per-row/B=2 bitwise vs plain; config = "
            f"twin {json.dumps(line)}")


def check_gradients(dev) -> None:
    """7b: ops.mwd_diff's gradients wrt cur, prev and the streams against
    torch.autograd through ops.naive at GRAD_GRID x GRAD_STEPS, within
    8·(atol + rtol·max(|ref|, 1)) of op.tolerance("f32"); the forward
    equals ops.mwd bitwise, the 1st-order stacked one too."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    for spec in list(st.SPECS.values()) + [mixed(ir)]:
        state, coeffs = st.make_problem(spec, GRAD_GRID, seed=3, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        gen = torch.Generator(device=dev).manual_seed(4)
        w = torch.randn(GRAD_GRID, generator=gen, device=dev)
        w2 = torch.randn(GRAD_GRID, generator=gen, device=dev)

        def grads(runner, **kw):
            args = [t.clone().requires_grad_() for t in (state[0], state[1])]
            arr = (arrays.clone().requires_grad_() if arrays is not None
                   else None)
            out = runner(spec, tuple(args),
                         ir.join_coeffs(spec, arr, scalars), GRAD_STEPS,
                         **kw)
            ins = args + ([arr] if arr is not None else [])
            g = torch.autograd.grad((w * out[0]).sum() + (w2 * out[1]).sum(),
                                    ins, allow_unused=True)
            return out, [torch.zeros_like(x) if gi is None else gi
                         for gi, x in zip(g, ins)]

        kw = dict(d_w=8, n_f=2)
        out, got = grads(ops.mwd_diff, **kw)
        fused = ops.mwd(spec, state, coeffs, GRAD_STEPS, **kw)
        check(all(same(a.detach(), b) for a, b in zip(out, fused)),
              f"{spec.name}: mwd_diff's forward (stacked: "
              f"{spec.time_order == 1 and spec.n_coeff_arrays > 0}) != "
              f"ops.mwd")
        _, want = grads(ops.naive)
        atol, rtol = spec.tolerance("f32")
        errs = {}
        for name, a, b in zip(("cur", "prev", "arrays"), got, want):
            mag = float(b.abs().max())
            errs[name] = max_err(a, b)
            check(errs[name] <= 8 * (atol + rtol * max(mag, 1.0)),
                  f"{spec.name}/{name}: gradient err {errs[name]:.3g} vs "
                  f"|ref| {mag:.3g}")
        log(f"  gradcheck {spec.name} {GRAD_GRID} x {GRAD_STEPS}: "
            f"{json.dumps(errs)} within 8·(atol + rtol·max(|ref|, 1)); "
            f"forward bitwise vs ops.mwd")


def diff_launches(spec, fwd, adj, n_steps) -> dict:
    """K1 launches of one forward + backward of ops.mwd_diff, one a
    diamond row: the forward (1-step advances where a 1st-order op stacks
    its states), then per step the adjoint advance and, at 2nd order, the
    reconstruction."""
    from repro_torch.core.mwd import k1_geometry
    rows = lambda p, n: k1_geometry(spec.radius, MAIN_GRID, p.d_w, p.n_f, n,
                                    fused=p.fused).comp.n_rows
    stacked = spec.time_order == 1 and spec.n_coeff_arrays > 0
    return {"forward": (n_steps * rows(fwd, 1) if stacked
                        else rows(fwd, n_steps)),
            "adjoint": n_steps * rows(adj, 1),
            "reconstruction": (n_steps * rows(fwd, 1)
                               if spec.time_order == 2 else 0)}


def diff_drive(spec, state, arrays, scalars, w, n_steps):
    """One forward + backward of ops.mwd_diff(plan="auto") whose loss reads
    the first output only (the second's cotangent is None), as the fit's;
    returns the gradients."""
    import torch
    from repro_torch.core import ir
    from repro_torch.kernels import ops
    args = [t.clone().requires_grad_() for t in (state[0], state[1])]
    arr = arrays.clone().requires_grad_() if arrays is not None else None
    out = ops.mwd_diff(spec, tuple(args), ir.join_coeffs(spec, arr, scalars),
                       n_steps, plan="auto")
    ins = args + ([arr] if arr is not None else [])
    return torch.autograd.grad((w * out[0]).sum(), ins, allow_unused=True)


def peak_gb(fn) -> tuple[float, float]:
    """(peak allocated GB during fn, that peak less what was allocated
    before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e9, (peak - base) / 1e9


def device_split(fn) -> dict:
    """One call of `fn` under torch.profiler: the device time of K1's
    kernels and of all other kernels (the plain-PyTorch terms), the wall
    time, the device's idle share of it and its five costliest operations
    by summed device time. None where the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    k1_ms = sum(e.time_range.elapsed_us() for e in kernels
                if "mwd_row_kernel" in e.name) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"k1_device_ms": k1_ms, "other_device_ms": busy_ms - k1_ms,
            "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ops": [{"name": n[:100], "ms": ms,
                                "share": ms / busy_ms} for n, ms in top]}


def phase_differentiable(tally: Tally, dev) -> dict:
    """Phase 7, the differentiable path: 7a, 7b, then at 512^3 x 8 steps per
    paper op ops.mwd_diff(plan="auto") forward and forward + backward by
    CUDA events, the K1 launches of one forward + backward (counted from
    0 just before the first call and read just after, each one the count
    of rows expected), K1 alone on one adjoint advance beside its bound
    and the K1 model, the peak memory (25pt-const at 8 and 32 steps:
    flat), the device-time split of one call (`device_split`), then
    launch.fit.run_fit at 512^3 and the fit gate of launch.fit.main at
    (8, 12, 10)."""
    import torch
    from repro_torch.core import ir, models, registry
    from repro_torch.core import stencils as st
    from repro_torch.kernels import adjoint, ops
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import fit
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    check_adjoint_k1(tally, dev)
    check_gradients(dev)
    log(f"  7a/7b: {time.perf_counter() - t0:.1f} s")
    rows, launches = {}, 0
    for name, spec in st.SPECS.items():
        state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        w = torch.randn(MAIN_GRID, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        fwd, fsrc = registry.resolve_plan(spec, MAIN_GRID, word_bytes=4)
        adj_plan, asrc = adjoint.resolve_adjoint_plan(spec, MAIN_GRID)
        check(fsrc == "registry:measured",
              f"{name}: the forward plan came from {fsrc}, not phase 2b")
        sm.LAUNCHES.count = 0
        grads = diff_drive(spec, state, arrays, scalars, w, MAIN_STEPS)
        torch.cuda.synchronize()
        n_call = sm.LAUNCHES.count
        launches += n_call
        check(all(g is None or bool(torch.isfinite(g).all()) for g in grads),
              f"{name}: non-finite gradient at {MAIN_GRID}")
        del grads
        expect = diff_launches(spec, fwd, adj_plan, MAIN_STEPS)
        check(n_call == sum(expect.values()),
              f"{name}: {n_call} K1 launches in one forward + backward, "
              f"expected {expect}")
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: ops.mwd_diff(
                spec, state, coeffs, MAIN_STEPS, plan="auto"), 2)
        both_ms = cuda_ms(lambda: diff_drive(spec, state, arrays, scalars, w,
                                             MAIN_STEPS), 2)
        peak, delta = peak_gb(lambda: diff_drive(spec, state, arrays,
                                                 scalars, w, MAIN_STEPS))
        split = device_split(lambda: diff_drive(spec, state, arrays, scalars,
                                                w, MAIN_STEPS))
        # K1 alone on one adjoint advance, beside its bound and the model
        adj = ir.adjoint(spec)
        adj_arrays, adj_scalars = adj.map_coeffs(arrays, scalars)
        kw = dict(d_w=adj_plan.d_w, n_f=adj_plan.n_f, fused=adj_plan.fused)
        adj_ms = k1_ms(adj.op, state, adj_arrays, adj_scalars, kw, 1)
        cfg = twin_line(adj.op, sm.kernel_config(sm.prepare(
            adj.op, state, adj_arrays, adj_scalars, 1, **kw)), adj_plan.d_w,
            adj_plan.n_f, MAIN_GRID[2])
        b_ms, b_by = bound(adj.op, MAIN_GRID, 1)
        model_ms = models.k1_predict(adj.op, MAIN_GRID, adj_plan.d_w,
                                     adj_plan.n_f, 1,
                                     fused=adj_plan.fused).t_total * 1e3
        del adj_arrays
        row = {"op": name, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "fwd_plan": f"dw{fwd.d_w}.nf{fwd.n_f}."
                           f"{'fused' if fwd.fused else 'row'}",
               "vjp_plan": f"dw{adj_plan.d_w}.nf{adj_plan.n_f}."
                           f"{'fused' if adj_plan.fused else 'row'}",
               "vjp_plan_source": asrc, "fwd_ms": fwd_ms,
               "fwd_bwd_ms": both_ms, "bwd_over_fwd": both_ms / fwd_ms,
               "k1_launches": n_call,
               **{f"{k}_launches": v for k, v in expect.items()},
               "adjoint_streams": adj.op.n_coeff_arrays,
               "adjoint_k1_ms": adj_ms, "adjoint_bound_ms": b_ms,
               "adjoint_bound_by": b_by, "adjoint_share": b_ms / adj_ms,
               "adjoint_model_ms": model_ms, "adjoint_config": cfg,
               "peak_gb": peak, "peak_over_start_gb": delta,
               "profiled_fwd_bwd": split}
        if spec.time_order == 2:
            flat = {n: peak_gb(lambda n=n: diff_drive(
                spec, state, arrays, scalars, w, n))[1] for n in FLAT_STEPS}
            check(flat[FLAT_STEPS[1]] <= flat[FLAT_STEPS[0]] * 1.001,
                  f"{name}: backward peak grows with the steps: {flat}")
            row["peak_over_start_gb_by_steps"] = flat
        rows[name] = row
        log("diff " + json.dumps(row))
        del state, coeffs, arrays, w
        torch.cuda.empty_cache()
    # 7d: the fit at full width, then the reference's CI gate on the card
    spec = st.SPECS["7pt-var"]
    reports = []
    sm.LAUNCHES.count = 0
    fit_peak = peak_gb(lambda: reports.append(fit.run_fit(
        spec, MAIN_GRID, n_steps=MAIN_STEPS, windows=2, max_steps=FIT_STEPS,
        plan="auto", telemetry="", device=dev, device_draws=True)))
    launches += sm.LAUNCHES.count
    rep = reports[0]
    check(rep["loss"] < rep["loss0"] and math.isfinite(rep["loss"]),
          f"fit at {MAIN_GRID}: loss {rep['loss0']} -> {rep['loss']}")
    fit_row = {"op": spec.name, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "windows": 2, "opt_steps": FIT_STEPS,
               "s_per_step": rep["seconds"] / FIT_STEPS,
               "loss0": rep["loss0"], "loss": rep["loss"],
               "peak_gb": fit_peak[0], "peak_over_start_gb": fit_peak[1]}
    rows["fit"] = fit_row
    log("fit " + json.dumps(fit_row))
    torch.cuda.empty_cache()
    t_gate = time.perf_counter()
    try:
        gate = fit.main(["--gate", "10", "--max-steps", "40", "--grid",
                         "8,12,10", "--telemetry", ""])
    except SystemExit as e:
        raise Failed(f"launch.fit.main's gate exited {e.code}") from e
    log("fit_gate " + json.dumps({
        "grid": [8, 12, 10], "steps": gate["steps"],
        "loss0": gate["loss0"], "loss": gate["loss"],
        "reduction": gate["reduction"],
        "seconds": time.perf_counter() - t_gate}))
    rows["launches"] = launches
    log(f"phase 7 differentiable path: {time.perf_counter() - t0:.1f} s")
    return rows


# phase 8: the distributed stepper on a 2x2 mesh of shards, all on the card
DIST_MESH = (2, 2)
DIST_TBLOCK = 2
DIST_COMPRESS_OPS = ("7pt-var", "25pt-const")
COMPRESS_BUDGET = 5e-2          # the reference's budget against naive
VJP_GRID = (256, 256, 256)
VJP_STEPS = 4
VJP_OPS = ("7pt-var", "25pt-var")
ELASTIC_OP = "7pt-var"
DIST_REPS = 3


def dist_mesh(dev):
    from repro_torch.launch import mesh as launch_mesh
    n = DIST_MESH[0] * DIST_MESH[1]
    return launch_mesh.make_debug_mesh(DIST_MESH, devices=[dev] * n)


def min_ms(fn, reps):
    """Min ms of `fn` over `reps` turns by CUDA events."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def check_shard_k1(tally: Tally, dev, spec, plan) -> list:
    """8a: K1 against its plain version on shard-shaped blocks of the 512^3
    grid over the 2x2 mesh: the whole extended block with the runtime
    interior of a corner shard and of an inner-edge shard (a z neighbour
    on both sides, as on a mesh of four z shards), and each zone slab of
    the overlapped schedule; every kernel_config equal to the fit twin."""
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.distributed import stepper
    g = spec.radius * DIST_TBLOCK
    nz_l, ny_l = MAIN_GRID[0] // DIST_MESH[0], MAIN_GRID[1] // DIST_MESH[1]
    ext = (nz_l + 2 * g, ny_l + 2 * g, MAIN_GRID[2] + 2 * g)
    part = stepper.partition_geometry((nz_l, ny_l, MAIN_GRID[2]), g, True,
                                      True)
    state, coeffs = st.random_problem(spec, ext, seed=5, device=dev)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    blocks = [("corner", (slice(None), slice(None)), (-g, -g)),
              ("inner-edge", (slice(None), slice(None)), (nz_l - g, -g))]
    blocks += [(zn.name, (zn.z, zn.y), (zn.origin[0], zn.origin[1]))
               for zn in part.zones]
    lines = []
    for name, (zs, ys), origin in blocks:
        a, b = (t[zs, ys].contiguous() for t in state)
        arr = arrays[:, zs, ys].contiguous() if arrays is not None else None
        pb = stepper.cap_plan_d_w(spec, plan, a.shape[1])
        interior = stepper.block_interior(spec, MAIN_GRID, g, a.shape, origin)
        _, bitwise, cfg = tally.kernel_vs_plain(
            spec, (a, b), arr, scalars, DIST_TBLOCK, d_w=pb.d_w, n_f=pb.n_f,
            fused=pb.fused, interior=interior, y_domain=(0, a.shape[1]))
        # the twin prices the default interior, x width nx - 2R: a shard
        # block's x interior is the global grid's
        twin = twin_line(spec, cfg, pb.d_w, pb.n_f, MAIN_GRID[2])
        lines.append({"block": name, "shape": list(a.shape),
                      "interior": list(interior),
                      "plan": f"dw{pb.d_w}.nf{pb.n_f}", "bitwise": bitwise,
                      "config": twin})
    return lines


def check_compressed(spec, mesh, state, coeffs, naive) -> dict:
    """8b, compressed halos: K1's route synchronous and overlapped and the
    plain route (the reference's executor, which the CPU tests hold within
    1e-5 of the reference's compressed output) all bitwise equal, not equal
    to the exact run; the error against naive beside the reference's
    budget (`within_budget`, a reading: the budget was set at the
    reference's test grids)."""
    from repro_torch.distributed import stepper
    runs = {key: stepper.run_distributed(
        spec, mesh, state, coeffs, MAIN_STEPS, DIST_TBLOCK, plan=plan,
        compress=True, overlap=ovl)
        for key, plan, ovl in (("k1", "auto", False),
                               ("k1_overlap", "auto", True),
                               ("plain", None, False))}
    for key in ("k1_overlap", "plain"):
        check(all(same(a, b) for a, b in zip(runs["k1"], runs[key])),
              f"{spec.name}: compressed {key} != compressed K1 route "
              f"({first_difference(runs[key], runs['k1'])})")
    err = max_err(runs["k1"][0], naive[0])
    check(err > 0.0, f"{spec.name}: the compressed run equals the exact one")
    return {"err_vs_naive": err, "budget": COMPRESS_BUDGET,
            "within_budget": err < COMPRESS_BUDGET,
            "naive_abs_max": float(naive[0].abs().max()),
            "bitwise_k1_overlap_plain": True}


def dist_pieces(spec, mesh, state, coeffs, plan):
    """One overlapped super-step's pieces as callables: the exchange alone
    (landed), the interior K1 launches and the boundary K1 launches."""
    from repro_torch.distributed import halo, stepper
    gs = stepper.GridSharding(mesh)
    g = spec.radius * DIST_TBLOCK
    cur_g = gs.shard(state[0])
    prev_g = gs.shard(state[1]) if spec.time_order == 2 else cur_g
    arrays, scalars = stepper.canonical_coeffs(spec, coeffs)
    hoisted = stepper.make_coeff_extender(spec, DIST_TBLOCK)(
        (gs.shard(arrays) if arrays is not None else None, scalars))
    part = stepper.partition_geometry(cur_g[0][0].shape, g, True, True)
    nz_l, ny_l, _ = part.local_shape
    ex = stepper._Exchange(spec, g, cur_g, prev_g, None, halo.Wire())
    cur_e, prev_e = ex.land()
    azs, ays = slice(g, g + nz_l), slice(g, g + ny_l)

    def exchange():
        stepper._Exchange(spec, g, cur_g, prev_g, None, halo.Wire()).land()

    def interior():
        for iz, iy in gs.cells():
            stepper._mwd_block(spec, plan, scalars, DIST_TBLOCK, MAIN_GRID,
                               g, ex.cur_x[iz][iy], ex.prev_x[iz][iy],
                               hoisted.block(iz, iy, g, azs, ays),
                               (iz * nz_l, iy * ny_l))

    def boundary():
        for iz, iy in gs.cells():
            for zn in part.zones:
                stepper._mwd_block(
                    spec, plan, scalars, DIST_TBLOCK, MAIN_GRID, g,
                    cur_e[iz][iy][zn.z, zn.y], prev_e[iz][iy][zn.z, zn.y],
                    hoisted.block(iz, iy, g, zn.z, zn.y),
                    (iz * nz_l + zn.origin[0], iy * ny_l + zn.origin[1]))

    return exchange, interior, boundary, part


def phase_distributed(tally: Tally, dev) -> dict:
    """Phase 8, the distributed stepper on a 2x2 mesh over [cuda:0] * 4:
    8a K1 on shard blocks and zone slabs; 8b run_distributed(plan="auto")
    at 512^3 x 8 steps per paper op, synchronous and overlapped, bitwise
    equal to each other and to ops.naive, and compress=True within the
    reference's budget; 8c the times (`distributed` lines); 8d
    distributed_vjp against mwd_diff at 256^3; 8e the elastic shrink and
    grow; 8f the sweep's distributed leg, the scaling lattice and the
    scaling gate's reading. Returns K1's launches of 8b's runs."""
    import torch
    from repro_torch.core import ir, models, registry
    from repro_torch.core import stencils as st
    from repro_torch.distributed import halo, stepper
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh = dist_mesh(dev)
    nz_l, ny_l = MAIN_GRID[0] // DIST_MESH[0], MAIN_GRID[1] // DIST_MESH[1]
    launches, rows = 0, {}
    for name, spec in st.SPECS.items():
        plan, source = stepper.resolve_shard_plan(spec, mesh, MAIN_GRID,
                                                  DIST_TBLOCK)
        shard_k1 = check_shard_k1(tally, dev, spec, plan)
        log(f"  8a {name}: K1 = plain bitwise on " + json.dumps(shard_k1))
        state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0,
                                          device=dev)
        run = {}
        counts = {}
        for ovl in (False, True):
            sm.LAUNCHES.count = 0
            run[ovl] = stepper.run_distributed(
                spec, mesh, state, coeffs, MAIN_STEPS, DIST_TBLOCK,
                plan="auto", overlap=ovl)
            torch.cuda.synchronize()
            counts[ovl] = sm.LAUNCHES.count
            launches += counts[ovl]
        naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
        check(all(same(a, b) for a, b in zip(run[False], run[True])),
              f"{name}: overlapped != synchronous at 512^3 "
              f"({first_difference(run[True], run[False])})")
        check(all(same(a, b) for a, b in zip(run[False], naive)),
              f"{name}: distributed != ops.naive at 512^3 "
              f"({first_difference(run[False], naive)})")
        del run
        comp = None
        if name in DIST_COMPRESS_OPS:
            comp = check_compressed(spec, mesh, state, coeffs, naive)
        del naive
        # 8c: the times
        call = {ovl: min_ms(lambda ovl=ovl: stepper.run_distributed(
            spec, mesh, state, coeffs, MAIN_STEPS, DIST_TBLOCK, plan="auto",
            overlap=ovl), DIST_REPS) for ovl in (False, True)}
        single_ms = min_ms(lambda: ops.mwd(spec, state, coeffs, MAIN_STEPS,
                                           plan="auto"), DIST_REPS)
        exchange, interior, boundary, part = dist_pieces(spec, mesh, state,
                                                         coeffs, plan)
        t_exch = min_ms(exchange, DIST_REPS)
        t_int = min_ms(interior, DIST_REPS)
        t_bnd = min_ms(boundary, DIST_REPS)
        n_super = MAIN_STEPS // DIST_TBLOCK
        g = spec.radius * DIST_TBLOCK
        streams = 2 if spec.time_order == 2 else 1
        hb = 4 * halo.halo_bytes((nz_l, ny_l, MAIN_GRID[2]), g, 4, streams)
        ext = stepper.local_extended_shape(spec, mesh, MAIN_GRID, DIST_TBLOCK)
        # what the exchange writes: every shard's whole x-padded extended
        # block (its own cells copied in too), per stream
        moved = 4 * streams * 4 * ext[0] * ext[1] * ext[2]
        peak = peak_gb(lambda: stepper.run_distributed(
            spec, mesh, state, coeffs, MAIN_STEPS, DIST_TBLOCK, plan="auto",
            overlap=True))
        split = device_split(lambda: stepper.run_distributed(
            spec, mesh, state, coeffs, MAIN_STEPS, DIST_TBLOCK, plan="auto",
            overlap=True))
        row = {"op": name, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "mesh": list(DIST_MESH), "t_block": DIST_TBLOCK,
               "plan": f"dw{plan.d_w}.nf{plan.n_f}."
                       f"{'fused' if plan.fused else 'row'}",
               "plan_source": source, "local_extended_shape": list(ext),
               "sync_ms": call[False], "overlap_ms": call[True],
               "single_device_mwd_ms": single_ms,
               "exchange_ms": t_exch, "interior_k1_ms": t_int,
               "boundary_k1_ms": t_bnd,
               "sync_super_step_ms": call[False] / n_super,
               "overlap_super_step_ms": call[True] / n_super,
               "model_sync_super_step_ms": models.super_step_time(
                   t_int, t_bnd, t_exch, overlap=False),
               "model_overlap_super_step_ms": models.super_step_time(
                   t_int, t_bnd, t_exch, overlap=True),
               "halo_bytes": hb, "halo_gb_s": hb / t_exch / 1e6,
               "exchange_written_bytes": moved,
               "exchange_written_gb_s": moved / t_exch / 1e6,
               "k1_launches_sync": counts[False],
               "k1_launches_overlap": counts[True],
               "peak_gb": peak[0], "peak_over_start_gb": peak[1],
               "profiled_overlap": split, "compressed": comp,
               "shard_k1": [{k: v for k, v in ln.items() if k != "config"}
                            for ln in shard_k1]}
        rows[name] = row
        log("distributed " + json.dumps(row))
        del state, coeffs
        torch.cuda.empty_cache()
    log(f"  8a-8c: {time.perf_counter() - t0:.1f} s")
    rows["vjp"] = dist_vjp(dev, mesh)
    rows["elastic"] = dist_elastic(dev)
    rows["sweep"] = dist_sweep(dev)
    rows["launches"] = launches
    log(f"phase 8 distributed: {time.perf_counter() - t0:.1f} s")
    return rows


def dist_vjp(dev, mesh) -> dict:
    """8d: distributed_vjp(plan="auto") against ops.mwd_diff's gradients of
    the same loss at 256^3 x 4 steps, within op.tolerance("f32")."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import adjoint, ops
    from repro_torch.kernels import stencil_mwd as sm
    out = {}
    for name in VJP_OPS:
        spec = st.SPECS[name]
        state, coeffs = st.random_problem(spec, VJP_GRID, seed=2, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        w = torch.randn(VJP_GRID, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        sm.LAUNCHES.count = 0
        outs, vjp = adjoint.distributed_vjp(spec, mesh, state, coeffs,
                                            VJP_STEPS, t_block=DIST_TBLOCK,
                                            plan="auto")
        got = vjp((w, torch.zeros_like(w)))
        torch.cuda.synchronize()
        n_k1 = sm.LAUNCHES.count
        args = [t.clone().requires_grad_() for t in state]
        arr = arrays.clone().requires_grad_() if arrays is not None else None
        ref = ops.mwd_diff(spec, tuple(args),
                           ir.join_coeffs(spec, arr, scalars), VJP_STEPS,
                           plan="auto")
        ins = args + ([arr] if arr is not None else [])
        want = torch.autograd.grad((w * ref[0]).sum(), ins, allow_unused=True)
        atol, rtol = spec.tolerance("f32")
        errs, bitwise = [], True
        for a, b in zip(got, want):
            if b is None:
                continue
            err = max_err(a, b)
            errs.append(err)
            bitwise = bitwise and same(a, b)
            scale = max(float(b.abs().max()), 1.0)
            check(err <= atol + rtol * scale,
                  f"{name}: distributed_vjp gradient err {err:.3g} beyond "
                  f"{(atol, rtol)} x {scale:.3g}")
        out[name] = {"grid": list(VJP_GRID), "steps": VJP_STEPS,
                     "max_err": max(errs), "bitwise": bitwise,
                     "k1_launches": n_k1}
        del state, coeffs, arrays, w, outs, got, want, ref, args, arr
        torch.cuda.empty_cache()
    log("distributed_vjp " + json.dumps(out))
    return out


def dist_elastic(dev) -> dict:
    """8e: ElasticStencilRun on 7pt-var at 512^3: 4 steps on 4 shards,
    save, rescale to 2, 2 steps, save, rescale to 4, 2 steps; bitwise equal
    to an uninterrupted 8-step run and to ops.naive, each shard key tuned
    once before and resolved from the registry at every rebuild."""
    import torch
    from repro_torch.core import autotune, registry
    from repro_torch.core import stencils as st
    from repro_torch.distributed import elastic, stepper
    from repro_torch.kernels import ops
    from repro_torch.launch import tune
    t0 = time.perf_counter()
    spec = st.SPECS[ELASTIC_OP]
    pool = [dev] * 4
    state, coeffs = st.random_problem(spec, MAIN_GRID, seed=4, device=dev)
    reg = registry.default_registry()
    for n in (4, 2):
        key = stepper.local_extended_shape(spec, elastic.build_mesh(n, pool),
                                           MAIN_GRID, DIST_TBLOCK)
        tune.tune_one(spec, key, reg, word_bytes=4, measured=True,
                      max_evals=4, n_steps=DIST_TBLOCK, device=dev)
    t_tune = time.perf_counter() - t0
    measured = []
    real = autotune.time_mwd_launch

    def counting(*a, **k):
        measured.append(1)
        return real(*a, **k)

    autotune.time_mwd_launch = counting
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
            run = elastic.ElasticStencilRun(spec, state, coeffs, d,
                                            t_block=DIST_TBLOCK, plan="auto",
                                            overlap="auto", n_devices=4,
                                            devices=pool)
            sources = [run.plan_source]
            run.advance(4)
            run.save()
            run.rescale(2)
            sources.append(run.plan_source)
            run.advance(2)
            run.save()
            run.rescale(4)
            sources.append(run.plan_source)
            run.advance(2)
            got = run.state
    finally:
        autotune.time_mwd_launch = real
    check(not measured, f"elastic: a rebuild measured {len(measured)} plans")
    check(all(s.startswith("registry") for s in sources),
          f"elastic: plan sources {sources}")
    whole = stepper.run_distributed(spec, elastic.build_mesh(4, pool), state,
                                    coeffs, MAIN_STEPS, DIST_TBLOCK,
                                    plan="auto", overlap="auto")
    naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
    check(all(same(a, b) for a, b in zip(got, whole)),
          "elastic run != uninterrupted 8-step run")
    check(all(same(a, b) for a, b in zip(got, naive)),
          "elastic run != ops.naive")
    out = {"op": ELASTIC_OP, "grid": list(MAIN_GRID), "plan_sources": sources,
           "bitwise_vs_uninterrupted": True, "tune_s": t_tune,
           "seconds": time.perf_counter() - t0}
    log("elastic " + json.dumps(out))
    del state, coeffs, got, whole, naive
    torch.cuda.empty_cache()
    return out


def dist_sweep(dev) -> dict:
    """8f: the sweep's distributed leg at 512^3 x 8 steps for the four paper
    ops on 4 shards and the scaling lattice, every shard on the card, into
    a temporary results directory, then the scaling gate's reading (not a
    check: its premise, an exchange on a link of its own, does not hold on
    one card)."""
    import contextlib
    import io
    from repro_torch.core import registry
    from repro_torch.core import stencils as st
    from repro_torch.launch import scaling_gate, sweep
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dsweep_") as d:
        points = [sweep.PointSpec(spec, MAIN_GRID, MAIN_STEPS, True, 1, 4,
                                  distributed=True)
                  for spec in st.SPECS.values()]
        summary = sweep.run_sweep_points(
            points, registry=registry.default_registry(),
            results_path=os.path.join(d, "sweep.json"), device=dev.type,
            shards=4, verbose=False)
        for p in summary["points"].values():
            log("dist_point " + json.dumps({
                "stencil": p["stencil"], "plan": p["plan"],
                "plan_source": p["plan_source"], **{
                    k: p["measured"][k] for k in (
                        "t_s", "glups", "n_devices", "cards",
                        "local_extended_shape")},
                "model_glups": p["model"]["glups"]}))
        t_dist = time.perf_counter() - t0
        path = os.path.join(d, "sweep-scaling.json")
        sweep.run_sweep_points(sweep.scaling_points(4),
                               registry=registry.default_registry(),
                               results_path=path, device=dev.type,
                               verbose=False)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = scaling_gate.main(["--results", path])
        pairs = scaling_gate.scaling_pairs(scaling_gate.load_points(path))
    v = scaling_gate.verdict(pairs)
    out = {"distributed_points_s": t_dist,
           "scaling_s": time.perf_counter() - t0 - t_dist,
           "gate_exit": rc, "gate": v,
           "pairs": [{k: p[k] for k in ("stencil", "n_devices", "scaling",
                                        "ratio")} for p in pairs]}
    log("scaling_gate (a reading: every shard on one card) "
        + json.dumps(out))
    return out


GROUPSIZE_KEYS = ("cluster", "slab", "stage", "threads", "smem_bytes")


def groupsize_line(op: str, rows) -> dict:
    """Phase 9's `groupsize` line of one op: the model leg at each cluster
    size, then K1 measured at each size per plan, each beside the model."""
    model = [{k: r.data[k] for k in ("cluster", "fits", "model_ms",
                                     "smem_bytes", "ctas_sm")}
             for r in rows if r.data.get("op") == op and ".k1." not in r.name]
    measured = {}
    for r in rows:
        if r.data.get("op") != op or ".k1." not in r.name:
            continue
        d = r.data
        entry = {"cluster": d["cluster"], "fits": d["fits"]}
        if d["fits"]:
            cfg = d["config"]
            entry.update(k1_ms=d["k1_ms"], model_ms=d["model_ms"],
                         smem_bytes=cfg["smem_bytes"],
                         ctas_sm=d["twin"]["per_sm"],
                         max_active_clusters=cfg["max_active_clusters"],
                         slab=cfg["slab"], threads=cfg["threads"],
                         bitwise=d["bitwise"])
        else:
            entry["refused"] = d["refused"]
        measured.setdefault(d["plan"], []).append(entry)
    return {"op": op, "model_grid": "1024^3x8", "model": model,
            "k1_grid": "512^3x8", "measured": measured}


def phase_benches(dev) -> dict:
    """Phase 9: the paper's benchmark harness (repro_torch.benchmarks.run)
    at its card sizes, every bench but the soak (phase 4c runs it), in the
    run's own registry (phase 2b's measured entries at 512^3). One `bench`
    line per CSV row; a failed gate raises. One `groupsize` line per op;
    each K1 launch at a requested cluster is bitwise equal to its plain
    version (the bench's gate), its configuration the fit twin's at that
    size, and each refusal one the twin predicts. Returns the K1, K2 and
    K3 launches of the benches (the bench's comparisons with the plain
    versions excluded) and the groupsize lines."""
    import torch
    from repro_torch.benchmarks import run as bench
    from repro_torch.kernels import stencil_fused as fu
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.kernels import stencil_sweep as sw
    t0 = time.perf_counter()
    mods = {"mwd": sm, "sweep": sw, "fused": fu}
    b = bench.Bench(dev, echo=False)
    seconds = {}
    for m in mods.values():
        m.LAUNCHES.count = 0
    for name, fn in bench.BENCHES.items():
        if name == "soak":
            continue
        t = time.perf_counter()
        first = len(b.rows)
        fn(b)
        for r in b.rows[first:]:
            log("bench " + json.dumps({"bench": name, "name": r.name,
                                       "us_per_call": r.us,
                                       "derived": r.derived}))
        seconds[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    launches = {k: m.LAUNCHES.count for k, m in mods.items()}
    lines = {}
    for op in ("7pt-const", "25pt-var"):
        k1 = [r for r in b.rows
              if r.data.get("op") == op and ".k1." in r.name]
        for r in k1:
            d = r.data
            what = f"{op} {d['plan']} cluster {d['cluster']}"
            if d["fits"]:
                check(d["bitwise"], f"{what}: K1 != its plain version")
                check(d["twin"] is not None and all(
                    d["config"][k] == d["twin"][k] for k in GROUPSIZE_KEYS),
                      f"{what}: kernel {d['config']} vs fit twin {d['twin']}")
            elif d["refused"] in ("E_SMEM", "E_CLUSTER_SIZE"):
                check(d["twin"] is None,
                      f"{what}: refused {d['refused']}, twin {d['twin']}")
        check(sum(r.data["fits"] for r in k1) >= 2,
              f"{op}: fewer than two cluster sizes measured")
        lines[op] = groupsize_line(op, b.rows)
        log("groupsize " + json.dumps(lines[op]))
    log(f"phase 9 benches: {json.dumps(seconds)}; launches "
        f"{json.dumps(launches)}; {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "groupsize": lines}


# phase 10: the LM training path at full width, (arch, steps, batch)
LM_SEQ = 4096
LM_RUNS = (("llama3.2-1b", 3, 2), ("gemma3-1b", 2, 2),
           ("mamba2-130m", 2, 4))
LM_DECODE_POSITIONS = 16


def lm_step_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """FLOPs of one train step, forward and backward (3x the forward; the
    recomputation under remat not counted): 6 N per token for the
    parameters, plus causal attention (the pairs a query sees, its window
    on local layers) and the SSD's chunk-quadratic terms per layer."""
    tokens = batch * seq
    fwd = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "mamba":
            q = min(256, seq)
            h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            fwd += 2 * tokens * q * (n + h * p) + 4 * tokens * h * n * p
            continue
        w = cfg.window if kind == "local" else seq
        pairs = sum(min(t + 1, w) for t in range(seq)) if cfg.causal \
            else seq * seq
        fwd += 4 * batch * pairs * cfg.n_heads * cfg.resolved_head_dim
    return 6.0 * n_params * tokens + 3.0 * fwd


def lm_check_decode(cfg, params, dev) -> dict:
    """10d: float32 decode_step over LM_DECODE_POSITIONS positions against
    forward's logits at the same positions."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    n = LM_DECODE_POSITIONS
    toks = torch.randint(0, cfg.vocab_size, (1, n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.no_grad():
        want, _ = lm.forward(cfg32, p32, {"tokens": toks})
        cache = lm.init_cache(cfg32, 1, n, device=dev)
        got = []
        for t in range(n):
            lg, cache = lm.decode_step(cfg32, p32, cache, toks[:, t:t + 1])
            got.append(lg)
        got = torch.cat(got, dim=1)
    scale = float(want.abs().max())
    err = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
          f"10d: decode vs forward max err {err} vs 1e-3 x {scale}")
    return {"positions": n, "max_abs_err": err, "max_abs_logit": scale}


def lm_line(arch, cfg, batch, records, peak, prof) -> dict:
    """One `lm_train` line from a launcher run's records."""
    from repro_torch.models import lm
    from repro_torch.models.params import count_params
    from repro_torch.launch import dryrun, roofline
    specs = lm.param_specs(cfg)
    n_params = count_params(specs)
    tokens = batch * LM_SEQ
    step_ms = statistics.median(r["ms"] for r in records[1:])
    flops = lm_step_flops(cfg, n_params, batch, LM_SEQ)
    bound_ms = flops / chip().peak_flops_bf16 * 1e3
    n_total, n_active = roofline.active_params(cfg, specs)
    t = time.perf_counter()
    counted, _ = dryrun.count_step(cfg, "train", batch, LM_SEQ,
                                   chunk=min(LM_SEQ, 2048))
    return {"arch": arch, "params": n_params, "batch": batch,
            "seq": LM_SEQ, "tokens_per_step": tokens,
            "steps": len(records), "first_step_ms": records[0]["ms"],
            "step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gb": peak, "step_flops": flops,
            "model_flops": roofline.model_flops(
                cfg, {"kind": "train", "global_batch": batch,
                      "seq_len": LM_SEQ}, n_total, n_active),
            "meta_counted_flops": counted,
            "meta_count_s": time.perf_counter() - t,
            "bound_ms_bf16_peak": bound_ms, "mfu": bound_ms / step_ms,
            "losses": [r["loss"] for r in records],
            "profiled_step": prof}


def lm_check_resumed_state(want, got) -> dict:
    """10a: every leaf of the resumed run's end state (params, AdamW
    moments, step) against the straight run's, within 1e-3 of the leaf's
    largest magnitude; reports whether all of them are bitwise equal."""
    import torch
    from repro_torch.optim.optimizers import tree_paths
    want, got = dict(tree_paths(want)), dict(tree_paths(got))
    check(sorted(want) == sorted(got), "10a resumed state has other leaves")
    names = sorted(want)
    with torch.no_grad():
        errs = torch.stack([
            (got[n].float() - want[n].float()).abs().max().to("cpu")
            for n in names]).tolist()
        scales = torch.stack([want[n].float().abs().max().to("cpu")
                              for n in names]).tolist()
        same = all(torch.equal(got[n], want[n]) for n in names)
    worst = max(range(len(names)), key=lambda i: errs[i] / (scales[i] or 1))
    check(all(e <= 1e-3 * s for e, s in zip(errs, scales)),
          f"10a resumed state differs: {names[worst]} max err "
          f"{errs[worst]} vs 1e-3 x {scales[worst]}")
    return {"leaves": len(names), "bitwise": same,
            "worst_leaf": names[worst], "max_abs_err": errs[worst],
            "max_abs": scales[worst]}


def phase_lm(dev) -> dict:
    """Phase 10: the LM training path at full width through
    launch.train.main; 10a llama3.2-1b with a checkpoint every 2 steps and
    a resumed run, 10b gemma3-1b, 10c mamba2-130m, 10d decode against
    forward at float32. One `lm_train` line per config."""
    import torch
    from repro_torch.distributed import checkpoint
    from repro_torch.launch import train
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"phase 10 start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated by earlier phases")
    lines = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        for arch, n_steps, batch in LM_RUNS:
            t = time.perf_counter()
            ckpt = os.path.join(tmp, arch)
            argv = ["--full", "--arch", arch, "--steps", str(n_steps),
                    "--batch", str(batch), "--seq", str(LM_SEQ),
                    "--device", "cuda"]
            if arch == "llama3.2-1b":
                argv += ["--ckpt", ckpt, "--ckpt-every", "2"]
            records = []
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t_main = time.perf_counter()
            state = train.main(argv, records=records)
            main_s = time.perf_counter() - t_main
            peak = torch.cuda.max_memory_allocated() / 1e9
            losses = [r["loss"] for r in records]
            check(all(math.isfinite(x) for x in losses),
                  f"10 {arch}: a loss is not finite: {losses}")
            # one more step under the profiler, on the state the run left:
            # the launcher's own step and pipeline for the same argv
            cfg, _, step, pipe = train.build(
                train.build_parser().parse_args(argv))
            data = pipe.get_batch(n_steps, cfg, device=dev)
            prof = device_split(lambda: float(step(state, data)[1]["loss"]))
            check(prof is not None, f"10 {arch}: the profiler saw no device "
                  "activity")
            line = lm_line(arch, cfg, batch, records, peak, prof)
            line["main_s"] = main_s
            if arch == "llama3.2-1b":
                line["decode_f32"] = lm_check_decode(cfg, state["params"],
                                                     dev)
                check(checkpoint.all_steps(ckpt) == [2],
                      f"10a checkpoints {checkpoint.all_steps(ckpt)}")
                resumed = []
                t_main = time.perf_counter()
                # resumed from step 2; it writes no checkpoint of its own
                end = train.main(argv[:-1] + ["100"], records=resumed)
                line["resume_main_s"] = time.perf_counter() - t_main
                check([r["step"] for r in resumed] == [2],
                      f"10a resumed steps {[r['step'] for r in resumed]}")
                rel = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
                       for a, b in zip(records[2:], resumed)]
                check(max(rel) <= 1e-3, f"10a resumed losses differ by {rel}")
                line["resumed_losses"] = [r["loss"] for r in resumed]
                line["resume_rel_err"] = max(rel)
                # step 2's update read the restored moments and step count:
                # the resumed run's end state is the straight run's
                line["resume_state"] = lm_check_resumed_state(state, end)
                del state, end
            else:
                del state
            line["phase_s"] = time.perf_counter() - t
            lines[arch] = line
            log("lm_train " + json.dumps(line))
            shutil.rmtree(ckpt, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10 lm: {time.perf_counter() - t0:.1f} s")
    return lines


# phase 11: the LM serving path at full width, (arch, batch, prompt, gen)
LM_SERVE_RUNS = (("llama3.2-1b", 8, 128, 128), ("gemma3-1b", 8, 512, 128),
                 ("mamba2-130m", 8, 128, 128))
LM_PREFILL_CHECK = 32       # prompt length of the float32 prefill check


def rewind(cache):
    """A decode cache with every ``length`` one step back."""
    if isinstance(cache, dict):
        return {k: v - 1 if k == "length" else rewind(v)
                for k, v in cache.items()}
    if isinstance(cache, list):
        return [rewind(v) for v in cache]
    return cache


def lm_check_prefill(cfg, params, dev) -> dict:
    """11: float32 prefill_into_cache over a LM_PREFILL_CHECK-token prompt
    against forward's last-position logits over the same prompt."""
    import dataclasses
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_map
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    toks = torch.randint(0, cfg.vocab_size, (1, LM_PREFILL_CHECK),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        want, _ = lm.forward(cfg32, p32, {"tokens": toks})
        got, _ = serve.prefill_into_cache(cfg32, p32, toks, 1)
    want = want[:, -1:]
    scale = float(want.abs().max())
    err = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
          f"11 {cfg.name}: prefill logits vs forward max err {err} vs "
          f"1e-3 x {scale}")
    return {"prompt": LM_PREFILL_CHECK, "max_abs_err": err,
            "max_abs_logit": scale}


def lm_check_place(cfg, dev) -> dict:
    """11: sharding.place of the parameters on the one-card mesh requests
    from the caching allocator exactly the per-device bytes local_shape
    gives (its `requested_bytes`; the blocks it hands out are rounded up
    and may keep an unsplit remainder, reported beside)."""
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import tree_sds
    from repro_torch.optim.optimizers import tree_map, tree_paths
    from repro_torch.training import sharding as shd
    specs = lm.param_specs(cfg)
    mesh = make_debug_mesh((1, 1), devices=[dev])
    shards = shd.param_shardings(mesh, specs)
    sds = tree_sds(specs)
    host = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), sds)
    want = shd.local_bytes(sds, shards)

    def counters():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats(dev)["requested_bytes.all.current"],
                torch.cuda.memory_allocated(dev))

    req0, alloc0 = counters()
    placed = shd.place(host, shards)
    req1, alloc1 = counters()
    on_card = all(t.device == dev for _, t in tree_paths(placed))
    del placed
    check(on_card and req1 - req0 == want,
          f"11 {cfg.name}: place requested {req1 - req0} bytes, "
          f"local_shape gives {want}")
    return {"local_bytes": want, "requested_bytes": req1 - req0,
            "allocated_bytes": alloc1 - alloc0}


def phase_lm_serve(dev) -> dict:
    """Phase 11: the LM serving path at full width through
    launch.serve.main, twice per config (the ids repeat and lie in
    [0, vocab)); one more decode step under the profiler on the state the
    run left; the decode step's HBM bound; the float32 prefill check and
    the placement check. One `lm_serve` line per config."""
    import torch
    from repro_torch.launch import roofline, serve
    from repro_torch.models import lm
    from repro_torch.training import steps as tsteps
    t0 = time.perf_counter()
    lines = {}
    for arch, batch, prompt, gen in LM_SERVE_RUNS:
        t = time.perf_counter()
        argv = ["--arch", arch, "--no-reduced", "--batch", str(batch),
                "--prompt-len", str(prompt), "--gen", str(gen),
                "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_main = time.perf_counter()
        rec = serve.main(argv)
        main_s = time.perf_counter() - t_main
        peak = torch.cuda.max_memory_allocated() / 1e9
        cfg, ids = rec["cfg"], rec["ids"]
        check(tuple(ids.shape) == (batch, gen)
              and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size,
              f"11 {arch}: ids {tuple(ids.shape)} in "
              f"[{int(ids.min())}, {int(ids.max())}], vocab {cfg.vocab_size}")
        serve_step = tsteps.make_serve_step(cfg)
        params, toks = rec["params"], rec["next"]
        # the run's last step again: every cache length one step back, so
        # it writes the last slot and reads what that step read
        cache = rewind(rec["cache"])
        prof = device_split(lambda: serve_step(params, cache, toks))
        check(prof is not None, f"11 {arch}: the profiler saw no device "
              "activity")
        prefill_check = lm_check_prefill(cfg, params, dev)
        timing = {k: rec[k] for k in ("prefill_ms", "decode_ms_per_token",
                                      "tokens_per_s")}
        del rec, params, cache, toks
        torch.cuda.empty_cache()
        t_again = time.perf_counter()
        again = serve.main(argv)
        again_s = time.perf_counter() - t_again
        check(torch.equal(again["ids"], ids),
              f"11 {arch}: a second serve with seed 0 gave other ids")
        del again
        torch.cuda.empty_cache()
        place = lm_check_place(cfg, dev)
        n_total, n_active = roofline.active_params(cfg, lm.param_specs(cfg))
        hbm = roofline.analytic_hbm_bytes(
            cfg, {"kind": "decode", "global_batch": batch,
                  "seq_len": prompt + gen}, n_total, n_active, 1)
        bound_ms = hbm / chip().hbm_bw * 1e3
        line = {"arch": arch, "params": n_total, "batch": batch,
                "prompt_len": prompt, "gen": gen, **timing,
                "peak_gb": peak, "decode_hbm_bytes": hbm,
                "decode_bound_ms": bound_ms,
                "decode_bound_share": bound_ms
                / timing["decode_ms_per_token"],
                "profiled_step": prof, "ids_in_range": True,
                "ids_repeat": True, "prefill_f32": prefill_check,
                "place": place, "main_s": main_s, "again_s": again_s,
                "phase_s": time.perf_counter() - t}
        lines[arch] = line
        log("lm_serve " + json.dumps(line))
    log(f"phase 11 lm serving: {time.perf_counter() - t0:.1f} s")
    return lines


# ---------------------------------------------------------------------------
# phase 12: the distributed stepper across processes
# ---------------------------------------------------------------------------

MP_GRID_B = (256, 256, 256)
MP_STEPS_B = 4
MP_OPS_B = ("7pt-var", "25pt-const")
MP_CKPT_OP = "7pt-var"
MP_CKPT_STEPS = (2, 2)
MP_DEADLINE_S = 420.0         # each spawn's join deadline
MP_REPS = 3


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def mp_join(rank, world_size, init_method, backend):
    """Join the group on this rank's card: cuda:0 for every gloo rank,
    cuda:rank under NCCL (one card per rank)."""
    import torch
    from repro_torch.distributed import process
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    process.initialize(backend, rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=MP_DEADLINE_S,
                       device=dev)
    return dev


class uncounted:
    """A block whose K1 launches leave K1's count as it was: the
    single-controller runs a rank compares its own with."""

    def __enter__(self):
        from repro_torch.kernels import stencil_mwd as sm
        self.count = sm.LAUNCHES.count

    def __exit__(self, *exc):
        from repro_torch.kernels import stencil_mwd as sm
        sm.LAUNCHES.count = self.count


def mp_plan(spec, mesh, grid):
    """The shard plan run_distributed(plan="auto") resolves: rank 0's,
    broadcast."""
    from repro_torch.distributed import process, stepper
    got = (stepper.resolve_shard_plan(spec, mesh, grid, DIST_TBLOCK)
           if process.process_index() == 0 else None)
    return process.broadcast_object(got)


def mp_checked_runs(spec, mesh, state, coeffs, grid, steps) -> int:
    """run_distributed(plan="auto") synchronous and overlapped; rank 0
    holds both against each other and ops.naive, bitwise. Returns this
    rank's K1 launches."""
    import torch
    from repro_torch.distributed import process, stepper
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    runs, launches = {}, 0
    for ovl in (False, True):
        before = sm.LAUNCHES.count
        runs[ovl] = stepper.run_distributed(spec, mesh, state, coeffs, steps,
                                            DIST_TBLOCK, plan="auto",
                                            overlap=ovl)
        torch.cuda.synchronize()
        launches += sm.LAUNCHES.count - before
    if process.process_index() == 0:
        naive = ops.naive(spec, state, coeffs, steps)
        check(all(same(a, b) for a, b in zip(runs[False], runs[True])),
              f"{spec.name} across ranks: overlapped != synchronous at "
              f"{grid} ({first_difference(runs[True], runs[False])})")
        check(all(same(a, b) for a, b in zip(runs[False], naive)),
              f"{spec.name} across ranks: != ops.naive at {grid} "
              f"({first_difference(runs[False], naive)})")
    return launches


def mp_carrier(spec, mesh, state, grid, compress, timed=False) -> dict:
    """One super-step's exchange through a Carrier: its bytes, checked
    equal to `stepper.rank_halo_bytes`, and (timed) its D2H, wire and H2D
    seconds."""
    import torch
    from repro_torch.distributed import halo, process, stepper
    gs = stepper.GridSharding(mesh)
    g = spec.radius * DIST_TBLOCK
    cur = gs.shard(state[0])
    prev = gs.shard(state[1]) if spec.time_order == 2 else cur
    err = (stepper.init_halo_error_global(spec, mesh, grid, DIST_TBLOCK)
           if compress else None)
    process.barrier()
    carrier = halo.Carrier(timed=timed)
    stepper._Exchange(spec, g, cur, prev, err, carrier).land()
    torch.cuda.synchronize()
    want = stepper.rank_halo_bytes(spec, mesh, grid, DIST_TBLOCK,
                                   process.process_index(), compress=compress)
    check(carrier.sent_bytes == want,
          f"{spec.name}: rank {process.process_index()}'s carrier sent "
          f"{carrier.sent_bytes} bytes, halo_bytes says {want}")
    out = {"bytes": carrier.sent_bytes, "halo_bytes": want}
    if timed:
        out.update({k.replace("_s", "_ms"): v * 1e3
                    for k, v in carrier.times.items()})
    return out


def mp_loop_ms(spec, mesh, state, coeffs, plan, overlap) -> dict:
    """The super-step loop alone (host clock, synchronized and behind a
    barrier at both ends, min of MP_REPS) and the gather of its result
    timed apart."""
    import torch
    from repro_torch.distributed import process, stepper
    gs = stepper.GridSharding(mesh)
    cur_g = gs.shard(state[0])
    prev_g = gs.shard(state[1]) if spec.time_order == 2 else cur_g
    arrays, scalars = stepper.canonical_coeffs(spec, coeffs)
    hoisted = stepper.make_coeff_extender(spec, DIST_TBLOCK)(
        (gs.shard(arrays) if arrays is not None else None, scalars))
    step = stepper.make_super_step(spec, mesh, MAIN_GRID, DIST_TBLOCK,
                                   plan=plan, overlap=overlap)

    def timed(fn):
        process.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        process.barrier()
        return (time.perf_counter() - t0) * 1e3, out

    def loop():
        c, p = cur_g, prev_g
        for _ in range(MAIN_STEPS // DIST_TBLOCK):
            c, p = step(c, p, hoisted)
        return c, p

    best, last = math.inf, None
    for _ in range(MP_REPS):
        ms, last = timed(loop)
        best = min(best, ms)
    gather_ms, _ = timed(lambda: (gs.gather(last[0]), gs.gather(last[1])))
    return {"loop_ms": best, "gather_ms": gather_ms}


def mp_rank_pair(rank, world_size, init_method, backend, ckpt_dir, full):
    """12a (and 12c, and the checkpoint at world size 2) on one rank of
    two, each with two mesh columns: a (2, 2) process mesh, z across
    ranks. `full` adds the timings, the profiler and 12c (the NCCL leg
    runs the checks alone). Raises on any failed check."""
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.distributed import checkpoint, process, stepper
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import mesh as launch_mesh
    dev = mp_join(rank, world_size, init_method, backend)
    try:
        mesh = launch_mesh.make_process_mesh([dev, dev])
        check(mesh.shape == {"data": 2, "model": 2},
              f"process mesh {mesh.shape}, want 2 x 2")
        sm.LAUNCHES.count = 0
        out = {"ops": {}}
        for name, spec in st.SPECS.items():
            torch.cuda.reset_peak_memory_stats()
            state, coeffs = st.random_problem(spec, MAIN_GRID, seed=0,
                                              device=dev)
            row = {"k1_launches": mp_checked_runs(spec, mesh, state, coeffs,
                                                  MAIN_GRID, MAIN_STEPS)}
            row["carrier"] = mp_carrier(spec, mesh, state, MAIN_GRID, False,
                                        timed=True)
            row["carrier_compressed"] = mp_carrier(spec, mesh, state,
                                                   MAIN_GRID, True)
            if full:
                plan, source = mp_plan(spec, mesh, MAIN_GRID)
                row["plan"] = (f"dw{plan.d_w}.nf{plan.n_f}."
                               f"{'fused' if plan.fused else 'row'}")
                row["plan_source"] = source
                for ovl in (False, True):
                    key = "overlap" if ovl else "sync"
                    row[key] = mp_loop_ms(spec, mesh, state, coeffs, plan,
                                          ovl)
                if name in DIST_COMPRESS_OPS:
                    row["compressed"] = mp_compressed(spec, mesh, state,
                                                      coeffs, dev)
                if rank == 0:
                    row["profiled_overlap"] = device_split(
                        lambda: stepper.run_distributed(
                            spec, mesh, state, coeffs, MAIN_STEPS,
                            DIST_TBLOCK, plan="auto", overlap=True))
                else:
                    stepper.run_distributed(spec, mesh, state, coeffs,
                                            MAIN_STEPS, DIST_TBLOCK,
                                            plan="auto", overlap=True)
                torch.cuda.synchronize()
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            out["ops"][name] = row
            del state, coeffs
            torch.cuda.empty_cache()
        if full:
            out["vjp"] = {name: mp_vjp(st.SPECS[name], mesh, dev)
                          for name in VJP_OPS}
            spec = st.SPECS[MP_CKPT_OP]
            state, coeffs = st.random_problem(spec, MP_GRID_B, seed=3,
                                              device=dev)
            got = stepper.run_distributed(spec, mesh, state, coeffs,
                                          MP_CKPT_STEPS[0], DIST_TBLOCK,
                                          plan="auto")
            checkpoint.save(ckpt_dir, MP_CKPT_STEPS[0],
                            {"cur": got[0], "prev": got[1]})
        out["launches"] = sm.LAUNCHES.count
        return out
    finally:
        process.finalize()


def mp_compressed(spec, mesh, state, coeffs, dev) -> dict:
    """compress=True across ranks: rank 0 holds it within 1e-5 of the
    single-controller compressed run on the same layout (four shards on
    the card) and reads it against the reference's budget."""
    from repro_torch.distributed import process, stepper
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as launch_mesh
    got = stepper.run_distributed(spec, mesh, state, coeffs, MAIN_STEPS,
                                  DIST_TBLOCK, plan="auto", compress=True)
    if process.process_index() != 0:
        return None
    with uncounted():
        single = stepper.run_distributed(
            spec, launch_mesh.make_debug_mesh((2, 2), devices=[dev] * 4),
            state, coeffs, MAIN_STEPS, DIST_TBLOCK, plan="auto",
            compress=True)
    vs_single = max(max_err(a, b) for a, b in zip(got, single))
    check(vs_single <= 1e-5, f"{spec.name}: compressed across ranks "
                             f"{vs_single} from the single-controller run")
    naive = ops.naive(spec, state, coeffs, MAIN_STEPS)
    err = max_err(got[0], naive[0])
    return {"err_vs_naive": err, "budget": COMPRESS_BUDGET,
            "within_budget": err < COMPRESS_BUDGET,
            "err_vs_single_controller": vs_single,
            "bitwise_single_controller": all(
                same(a, b) for a, b in zip(got, single))}


def mp_vjp(spec, mesh, dev) -> dict:
    """12c: distributed_vjp(plan="auto") at 256^3 x 4 across the ranks,
    bitwise against the single-controller one on the same layout."""
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.distributed import process
    from repro_torch.kernels import adjoint
    from repro_torch.launch import mesh as launch_mesh
    state, coeffs = st.random_problem(spec, VJP_GRID, seed=4, device=dev)
    w = torch.randn(VJP_GRID, generator=torch.Generator(dev).manual_seed(6),
                    device=dev)
    t0 = time.perf_counter()
    outs, vjp = adjoint.distributed_vjp(spec, mesh, state, coeffs, VJP_STEPS,
                                        t_block=DIST_TBLOCK, plan="auto")
    grads = vjp((w, torch.zeros_like(w)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if process.process_index() != 0:
        return {"s": seconds}
    mesh1 = launch_mesh.make_debug_mesh((2, 2), devices=[dev] * 4)
    with uncounted():
        outs1, vjp1 = adjoint.distributed_vjp(spec, mesh1, state, coeffs,
                                              VJP_STEPS, t_block=DIST_TBLOCK,
                                              plan="auto")
        want = [outs1[0]] + list(vjp1((w, torch.zeros_like(w))))
    got = [outs[0]] + list(grads)
    for i, (a, b) in enumerate(zip(got, want)):
        check((a is None) == (b is None) and (a is None or same(a, b)),
              f"{spec.name}: distributed_vjp across ranks, term {i}, != "
              f"the single-controller one")
    return {"s": seconds, "bitwise": True}


def mp_rank_quad(rank, world_size, init_method, backend, ckpt_dir):
    """12b and the checkpoint resumed at world size 4 on one rank of
    four, one mesh column each: a 2x2 make_mesh, both grid axes across
    ranks, so the z-y corners travel two cross-process hops."""
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.distributed import checkpoint, process, stepper
    from repro_torch.kernels import stencil_mwd as sm
    from repro_torch.launch import mesh as launch_mesh
    dev = mp_join(rank, world_size, init_method, backend)
    try:
        mesh = launch_mesh.make_mesh((2, 2), ("data", "model"), [
            process.ProcessDevice(p, 0, dev) for p in range(4)])
        sm.LAUNCHES.count = 0
        out = {"ops": {}}
        for name in MP_OPS_B:
            spec = st.SPECS[name]
            torch.cuda.reset_peak_memory_stats()
            state, coeffs = st.random_problem(spec, MP_GRID_B, seed=1,
                                              device=dev)
            t0 = time.perf_counter()
            n = mp_checked_runs(spec, mesh, state, coeffs, MP_GRID_B,
                                MP_STEPS_B)
            out["ops"][name] = {
                "k1_launches": n, "checked_s": time.perf_counter() - t0,
                "carrier": mp_carrier(spec, mesh, state, MP_GRID_B, False,
                                      timed=True),
                "carrier_compressed": mp_carrier(spec, mesh, state,
                                                 MP_GRID_B, True),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        spec = st.SPECS[MP_CKPT_OP]
        state, coeffs = st.random_problem(spec, MP_GRID_B, seed=3,
                                          device=dev)
        step, tree = checkpoint.restore(
            ckpt_dir, {"cur": state[0], "prev": state[1]})
        check(step == MP_CKPT_STEPS[0], f"restored step {step}")
        got = stepper.run_distributed(spec, mesh, (tree["cur"], tree["prev"]),
                                      coeffs, MP_CKPT_STEPS[1], DIST_TBLOCK,
                                      plan="auto")
        torch.cuda.synchronize()
        out["launches"] = sm.LAUNCHES.count
        if rank == 0:
            with uncounted():
                straight = stepper.run_distributed(
                    spec,
                    launch_mesh.make_debug_mesh((2, 2), devices=[dev] * 4),
                    state, coeffs, sum(MP_CKPT_STEPS), DIST_TBLOCK,
                    plan="auto")
            check(all(same(a, b) for a, b in zip(got, straight)),
                  f"checkpoint at world size 2 resumed at 4 != the straight "
                  f"run ({first_difference(got, straight)})")
            out["resumed_bitwise"] = True
        return out
    finally:
        process.finalize()


def phase_multiprocess(dist_rows: dict) -> dict:
    """Phase 12, the distributed stepper across processes: ranks spawned
    with torch.multiprocessing (spawn) on cuda:0 over gloo and a file
    store, each spawn under a join deadline (a rank that fails, or the
    deadline, ends every rank and the phase). 12a: 2 ranks of two mesh
    columns, a (2, 2) process mesh, 512^3 x 8 per paper op at plan="auto",
    synchronous and overlapped bitwise to each other and ops.naive,
    compress=True at 7pt-var and 25pt-const (within 1e-5 of the
    single-controller compressed run, a reading against the reference's
    budget); 12b: 4 ranks of one column, a 2x2 make_mesh, 256^3 x 4 for
    7pt-var and 25pt-const, bitwise against ops.naive; 12c: distributed_vjp
    at 256^3 x 4 across 2 ranks bitwise against the single-controller
    one, and a checkpoint written at world size 2 resumed at world size 4
    bitwise against the straight run; 12d: the `distributed_mp` lines.
    With two cards or more 12a's checks run again over NCCL, one card per
    rank. Returns the ranks' K1 launches."""
    import gc

    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    log(f"phase 12: parent holds {torch.cuda.memory_allocated() / 1e9:.2f} "
        f"GB before spawning")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mp_ckpt_")
    try:
        from repro_torch.distributed import process
        t_a = time.perf_counter()
        pair = process.launch(mp_rank_pair, 2, ("gloo", ckpt, True),
                              timeout_s=MP_DEADLINE_S)
        t_a = time.perf_counter() - t_a
        t_b = time.perf_counter()
        quad = process.launch(mp_rank_quad, 4, ("gloo", ckpt),
                              timeout_s=MP_DEADLINE_S)
        t_b = time.perf_counter() - t_b
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = (sum(r["launches"] for r in pair)
                + sum(r["launches"] for r in quad))
    for name in pair[0]["ops"]:
        rows = [r["ops"][name] for r in pair]
        r0 = rows[0]
        d8 = dist_rows.get(name, {})
        line = {
            "phase": "12a", "op": name, "grid": list(MAIN_GRID),
            "steps": MAIN_STEPS, "t_block": DIST_TBLOCK, "ranks": 2,
            "mesh": [2, 2], "backend": "gloo", "card": card,
            "plan": r0["plan"], "plan_source": r0["plan_source"],
            "sync_loop_ms": r0["sync"]["loop_ms"],
            "overlap_loop_ms": r0["overlap"]["loop_ms"],
            "gather_ms": r0["sync"]["gather_ms"],
            "single_controller_sync_ms": d8.get("sync_ms"),
            "single_controller_overlap_ms": d8.get("overlap_ms"),
            "single_device_mwd_ms": d8.get("single_device_mwd_ms"),
            "exchange_split_ms_per_rank": [
                {k: r["carrier"][k] for k in ("d2h_ms", "wire_ms", "h2d_ms")}
                for r in rows],
            "carrier_bytes_per_rank": [r["carrier"]["bytes"] for r in rows],
            "halo_bytes_per_rank": [r["carrier"]["halo_bytes"] for r in rows],
            "carrier_bytes_compressed_per_rank": [
                r["carrier_compressed"]["bytes"] for r in rows],
            "halo_bytes_compressed_per_rank": [
                r["carrier_compressed"]["halo_bytes"] for r in rows],
            "profiled_overlap_rank0": r0["profiled_overlap"],
            "peak_gb_per_rank": [r["peak_gb"] for r in rows],
            "k1_launches_per_rank": [r["k1_launches"] for r in rows],
            "compressed": r0.get("compressed"), "bitwise": True}
        log("distributed_mp " + json.dumps(line))
    for name in quad[0]["ops"]:
        rows = [r["ops"][name] for r in quad]
        line = {
            "phase": "12b", "op": name, "grid": list(MP_GRID_B),
            "steps": MP_STEPS_B, "t_block": DIST_TBLOCK, "ranks": 4,
            "mesh": [2, 2], "backend": "gloo", "card": card,
            "checked_s": rows[0]["checked_s"],
            "exchange_split_ms_per_rank": [
                {k: r["carrier"][k] for k in ("d2h_ms", "wire_ms", "h2d_ms")}
                for r in rows],
            "carrier_bytes_per_rank": [r["carrier"]["bytes"] for r in rows],
            "carrier_bytes_compressed_per_rank": [
                r["carrier_compressed"]["bytes"] for r in rows],
            "peak_gb_per_rank": [r["peak_gb"] for r in rows],
            "k1_launches_per_rank": [r["k1_launches"] for r in rows],
            "bitwise": True}
        log("distributed_mp " + json.dumps(line))
    log("distributed_mp " + json.dumps({
        "phase": "12c", "card": card, "vjp": pair[0]["vjp"],
        "vjp_s_per_rank": [{n: r["vjp"][n]["s"] for n in r["vjp"]}
                           for r in pair],
        "checkpoint": f"world size 2 -> 4 at {MP_GRID_B}, "
                      f"{MP_CKPT_STEPS[0]} + {MP_CKPT_STEPS[1]} steps",
        "resumed_bitwise": quad[0]["resumed_bitwise"],
        "spawn_s": {"pair": t_a, "quad": t_b}}))
    if torch.cuda.device_count() >= 2:
        nccl = process.launch(mp_rank_pair, 2, ("nccl", None, False),
                              timeout_s=MP_DEADLINE_S)
        launches += sum(r["launches"] for r in nccl)
        log("distributed_mp " + json.dumps({
            "phase": "12a-nccl", "card": card, "bitwise": True,
            "carrier_bytes_per_rank": [
                {n: r["ops"][n]["carrier"]["bytes"] for n in r["ops"]}
                for r in nccl]}))
    else:
        log("12 nccl leg: not run: torch.cuda.device_count() is "
            f"{torch.cuda.device_count()}, and NCCL needs one card per rank "
            "(two ranks on one card raise repro_torch's own error)")
    log(f"phase 12 multiprocess: {time.perf_counter() - t0:.1f} s "
        f"(K1 launches across ranks {launches})")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 13: the sharded LM step across torch.distributed ranks
# ---------------------------------------------------------------------------

LMS_RANKS = 4
LMS_DEADLINE_S = 480.0        # the spawn's join deadline
LMS_TRAIN = ("llama3.2-1b", 2, 512, 2)    # 13a: arch, batch, seq, steps
LMS_F32 = ("llama3.2-1b", 1, 2, 256)      # 13b: arch, layers, batch, seq
LMS_F32_MESH, LMS_CKPT_TO = (2, 2), (1, 4)
LMS_SERVE = ("llama3.2-1b", 8, 16, 8)     # 13d: arch, batch, prompt, gen
LMS_SERVE_LAYERS = 4                      # 13d's bf16 leg: 4 of 16 layers
LMS_SERVE_F32_GEN = 4


LMS_MAMBA = ("mamba2-130m", 4, 256, 2)     # 13e: arch, batch, seq, steps
LMS_MAMBA_SERVE = (8, 8, 4)                # 13e, float32: batch, prompt, gen
LMS_MAMBA_SERVE_LAYERS = 4                 # 13e's serving: 4 of 24 layers
LMS_WIDE = {"13f": ("mixtral-8x7b", 1), "13g": ("jamba-1.5-large-398b", 1)}
LMS_WIDE_BATCH, LMS_WIDE_MESH = (4, 128), (2, 2)
LMS_LONG = ("gemma3-1b", 32768, 30000, 2)  # 13h: arch, slots, length, tokens
LMS_LONG_MESH = (4, 1)
LMS_LONG_LAYERS = {"float32": 6, "bfloat16": 13}   # 13h: of 26 layers


def lms_mamba_argv() -> list:
    """13e's launcher arguments: the published width and depth, bf16."""
    arch, batch, seq, steps = LMS_MAMBA
    return ["--full", "--arch", arch, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--device", "cuda"]


def lms_mamba_serve_cfg():
    """13e's serving config: mamba2-130m at the published width, cut to
    LMS_MAMBA_SERVE_LAYERS layers, float32."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(LMS_MAMBA[0]), dtype="float32",
                               n_layers=LMS_MAMBA_SERVE_LAYERS)


def lms_wide_cfg(phase: str):
    """13f/13g's config: the published width, cut in depth, float32."""
    from repro_torch import configs
    arch, layers = LMS_WIDE[phase]
    return dataclasses.replace(configs.get(arch), n_layers=layers,
                               dtype="float32")


def lms_long_cfg(dtype: str):
    """13h's config: gemma3-1b at the published width, cut to
    LMS_LONG_LAYERS[dtype] layers (float32: five local and one global;
    bfloat16: half its depth, two global layers), in `dtype`."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(LMS_LONG[0]), dtype=dtype,
                               n_layers=LMS_LONG_LAYERS[dtype])


def lms_card_params(cfg, dev, mesh=None):
    """Seed-0 weights drawn on the card, leaf by leaf, by `tree_init`'s
    rule (ones or zeros for vectors, else normal over the fan-in), the
    same numbers on every rank; on a process `mesh` a rank keeps its
    blocks (`sharding.place`). Seconds, where the host draw of the
    published widths would take a minute a rank."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training import sharding as shd
    specs = lm.param_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one(s):
        if len(s.shape) == 1:
            return torch.full(s.shape, 1.0 if s.init_scale else 0.0,
                              dtype=s.torch_dtype, device=dev)
        std = s.init_scale / math.sqrt(max(math.prod(s.shape[:-1]), 1))
        return (torch.randn(s.shape, generator=gen, device=dev) * std).to(
            s.torch_dtype)

    if mesh is None:
        return tree_map(one, specs)
    return tree_map(lambda s, sh: shd.place(one(s), sh), specs,
                    shd.param_shardings(mesh, specs))


def lms_host_bytes(phase: str) -> dict:
    """The host bytes a weight draw holds at once at `phase`'s config,
    float32 draws: at most the `params.INIT_WORKERS` largest leaves
    (`sharding.init_blocks`, a leaf a thread), the largest leaf, and the
    whole tree (tree_init, then the blocks cut)."""
    from repro_torch.models import lm
    from repro_torch.models.params import INIT_WORKERS, sorted_leaves
    sizes = sorted(4 * math.prod(s.shape) for s in sorted_leaves(
        lm.param_specs(lms_wide_cfg(phase))))
    return {"host_bytes_at_most": sum(sizes[-INIT_WORKERS:]),
            "init_workers": INIT_WORKERS,
            "host_bytes_largest_leaf": sizes[-1],
            "host_bytes_whole_tree": sum(sizes)}


def lms_predraw(dev) -> dict:
    """13f's seed-0 weights, this rank's blocks drawn leaf by leaf on the
    host (`sharding.init_blocks` over a (2, 2) mesh of the ranks' CPUs),
    while the parent's one-process runs hold the card; their seconds."""
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import lm
    from repro_torch.training import sharding as shd
    specs = lm.param_specs(lms_wide_cfg("13f"))
    host = launch_mesh.rank_mesh(LMS_WIDE_MESH, device="cpu")
    t = time.perf_counter()
    params = shd.init_blocks(specs, 0, shd.param_shardings(host, specs))
    return {"params": params, "draw_s": time.perf_counter() - t}


def lms_dropped_share(cfg, params, batch) -> float:
    """The share of routed assignments that the experts' capacity drops
    in a forward of `batch` in one process: each MoE layer's router top-k
    counts beyond `moe.capacity`, read at its input (`moe.moe_ffn`
    wrapped for the call); None where no layer routes."""
    import torch
    from repro_torch.models import lm, moe
    dropped, routed, route = [], [], moe.moe_ffn

    def spy(p, c, x, act):
        xf = x.reshape(-1, x.shape[-1])
        idx = torch.topk(torch.softmax(xf.float() @ p["router"], -1),
                         c.experts_per_token, dim=-1)[1]
        counts = torch.bincount(idx.reshape(-1), minlength=c.n_experts)
        dropped.append(int(torch.clamp(
            counts - moe.capacity(c, xf.shape[0]), min=0).sum()))
        routed.append(idx.numel())
        return route(p, c, x, act)

    moe.moe_ffn = spy
    try:
        with torch.no_grad():
            lm.loss_fn(cfg, params, batch, chunk=batch["tokens"].shape[1])
    finally:
        moe.moe_ffn = route
    return sum(dropped) / sum(routed) if routed else None


def lms_wide_steps(phase: str, mesh, dev, pre=None,
                   profile: bool = False) -> dict:
    """13f/13g: two float32 train steps of `lms_wide_cfg(phase)` on a
    seed-0 batch (the sharded step on a process `mesh`, else one
    process), the second under torch.profiler where `profile`: step 0's
    metrics, the next loss, each step's ms, the weights' draw seconds,
    the optimizer state after the second update made whole on the host
    (Adafactor's, which that update reads back from the first), in one
    process MoE's dropped share (`lms_dropped_share`), and the state
    left. 13f's seed-0 weights come from the host (`tree_init`: a rank's
    blocks drawn leaf by leaf beforehand, `pre`), 13g's from the card
    (`lms_card_params`)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    from repro_torch.optim.optimizers import tree_map, tree_paths
    from repro_torch.training import sharding as shd
    from repro_torch.training import steps as tsteps
    cfg = lms_wide_cfg(phase)
    b, s = LMS_WIDE_BATCH
    opt, step = tsteps.make_train_step(cfg, chunk=s, mesh=mesh)
    specs = lm.param_specs(cfg)
    t = time.perf_counter()
    if phase == "13g":
        params = lms_card_params(cfg, dev, mesh)
    elif pre is not None:
        params = tree_map(lambda x: x.to(dev), pre["params"])
    else:
        params = tree_init(specs, seed=0, device=dev)
    torch.cuda.synchronize()
    out = {"draw_s": time.perf_counter() - t if pre is None
           else pre["draw_s"], "ms": [], "profiled": None,
           "dropped_share": None}
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                              dtype=torch.int32).to(dev)
             for k in ("tokens", "labels")}
    if mesh is None:
        out["dropped_share"] = lms_dropped_share(cfg, params, batch)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    del params
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ran = {}

        def run():
            ran["state"], ran["m"] = step(state, batch)
            ran["loss"] = float(ran["m"]["loss"])

        if i == 1 and profile:
            out["profiled"] = device_split(run)
        else:
            run()
        state, m, loss = ran["state"], ran["m"], ran["loss"]
        out["ms"].append((time.perf_counter() - t) * 1e3)
        if i == 0:
            out["m0"] = {k: float(v) for k, v in m.items()}
        else:
            out["loss1"] = loss
    if cfg.optimizer == "adafactor":
        new = state["opt"]
        if mesh is not None:
            new = shd.gather(new, tsteps.train_state_specs(cfg)[1](mesh)[
                "opt"])
        out["opt"] = {n: x.cpu() for n, x in tree_paths(new)}
    out.update(state=state, cfg=cfg)
    return out


def lms_long_cache(cfg, dev) -> dict:
    """13h's batch-1 cache of LMS_LONG's slots, whole, on the card: seeded
    normal entries (the same on every rank), every length LMS_LONG's."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_map
    _, slots, length, _ = LMS_LONG
    gen = torch.Generator(device=dev).manual_seed(1)
    return tree_map(
        lambda s: torch.full(s.shape, length, dtype=s.dtype, device=dev)
        if s.dtype == torch.int32 else torch.randn(
            s.shape, generator=gen, device=dev).to(s.dtype),
        lm.cache_spec(cfg, 1, slots))


def lms_long_decode(dtype: str, mesh, dev, rank: int = -1) -> dict:
    """13h: LMS_LONG's tokens of greedy batch-1 decode from
    `lms_long_cache` with `lms_card_params`, laid out by
    `steps.make_decoder` (on a process `mesh` the cache's KV slots over
    'data'), the last token under the profiler on `rank` 0
    (`lms_profiled`): the ids, the last step's logits made whole on the
    host, ms a token, and the state's bytes against `local_bytes`."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import tree_sds
    from repro_torch.training import sharding as shd
    from repro_torch.training import spmd
    from repro_torch.training import steps as tsteps
    cfg = lms_long_cfg(dtype)
    _, slots, _, n_tok = LMS_LONG
    specs = lm.param_specs(cfg)
    dec = tsteps.make_decoder(cfg, 1, slots, mesh=mesh)
    params = lms_card_params(cfg, dev, mesh)
    cache = dec.place(lms_long_cache(cfg, dev))
    out = {"profiled": None}
    if mesh is not None:
        out["state_bytes"] = lms_bytes(params) + lms_bytes(cache)
        out["local_bytes"] = shd.local_bytes(
            tree_sds(specs), shd.param_shardings(mesh, specs)) \
            + shd.local_bytes(lm.cache_spec(cfg, 1, slots), dec.shardings)
    tok = torch.full((1, 1), 7, dtype=torch.int32, device=dev)
    ids, ms, ran = [], [], {}
    for i in range(n_tok):
        torch.cuda.synchronize()
        t = time.perf_counter()

        def run():
            ran["out"] = dec.step(params, cache, tok)

        if i == n_tok - 1 and rank >= 0:
            out["profiled"] = lms_profiled(rank, run)
        else:
            run()
        tok, logits, cache = ran["out"]
        ids.append(int(tok))
        ms.append((time.perf_counter() - t) * 1e3)
    if mesh is not None and logits.shape[-1] != cfg.vocab_size:
        logits = spmd.all_gather(spmd.layout_of(mesh), "model", logits, -1,
                                 count=False)
    out.update(ids=ids, logits=logits.float().cpu(), ms=ms)
    return out


def lms_train_argv() -> list:
    """13a's launcher arguments: the published width, bf16."""
    arch, batch, seq, steps = LMS_TRAIN
    return ["--full", "--arch", arch, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--device", "cuda"]


def lms_f32_cfg(arch=LMS_F32[0], layers=LMS_F32[1]):
    """A config at the published width, `layers` deep, in float32."""
    return dataclasses.replace(lms_serve_cfg(arch, layers), dtype="float32")


def lms_serve_cfg(arch=LMS_SERVE[0], layers=LMS_SERVE_LAYERS):
    """A config at the published width, `layers` deep."""
    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), n_layers=layers)


def lms_f32_steps(mesh, dev) -> dict:
    """13b: two float32 train steps of `lms_f32_cfg` from seed-0 weights
    on a seed-0 batch (the sharded step on a process `mesh`, else the
    one-process step): step 0's metrics, the next loss, each step's ms
    and the state left."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.training import sharding as shd
    from repro_torch.training import steps as tsteps
    cfg = lms_f32_cfg()
    _, _, b, s = LMS_F32
    opt, step = tsteps.make_train_step(cfg, chunk=s, mesh=mesh)
    specs = lm.param_specs(cfg)
    params = tree_init(specs, seed=0, device="cpu")
    params = (shd.place(params, shd.param_shardings(mesh, specs))
              if mesh is not None else tree_map(lambda t: t.to(dev), params))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                              dtype=torch.int32).to(dev)
             for k in ("tokens", "labels")}
    out = {"ms": []}
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        out["ms"].append((time.perf_counter() - t) * 1e3)
        if i == 0:
            out["m0"] = {k: float(v) for k, v in m.items()}
        else:
            out["loss1"] = loss
    out.update(state=state, step=step, batch=batch, cfg=cfg)
    return out


def lms_close(got: float, want: float, tol: float) -> bool:
    return abs(got - want) <= tol * max(1.0, abs(want))


def lms_bytes(tree) -> int:
    from repro_torch.optim.optimizers import tree_paths
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


def lms_counter(counter: dict, step_s: float) -> dict:
    """A rank's collectives over the run: bytes and calls by kind, and
    the shares of the steps' time inside gloo and in staging."""
    return {"bytes": counter["bytes"], "calls": counter["calls"],
            "gloo_s": counter["wire_s"], "staging_s": counter["stage_s"],
            "gloo_share": counter["wire_s"] / step_s,
            "staging_share": counter["stage_s"] / step_s}


def lms_profiled(rank: int, fn):
    """`fn` on every rank, under the profiler on rank 0 (its device idle
    share and costliest operations)."""
    if rank == 0:
        return device_split(fn)
    fn()
    return None


def lms_wait(go: str) -> None:
    """Wait until the parent's one-process runs are done and it writes
    `go` ("run", or "abort" when they failed)."""
    t0 = time.perf_counter()
    while not os.path.exists(go):
        check(time.perf_counter() - t0 < LMS_DEADLINE_S,
              "13: the parent never released the ranks")
        time.sleep(0.2)
    with open(go) as f:
        check(f.read() == "run", "13: the parent's one-process runs failed")


def lms_warm(dev) -> None:
    """Load what a step of this rank uses on the card (the CUDA
    libraries, the kernels, the groups' connections) before the rank is
    released: reduced llama train steps in bf16 and float32 in this
    process alone, and the (1, 4) and (2, 2) groups. The card's work is a
    few milliseconds."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import tree_init
    from repro_torch.training import spmd
    from repro_torch.training import steps as tsteps
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                                  dtype=dtype)
        opt, step = tsteps.make_train_step(cfg, chunk=16)
        params = tree_init(lm.param_specs(cfg), seed=0, device=dev)
        batch = {k: torch.zeros((2, 16), dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        float(step({"params": params, "opt": opt.init(params),
                    "step": torch.zeros((), dtype=torch.int32)},
                   batch)[1]["loss"])
    for shape in ((1, 4), LMS_F32_MESH):
        spmd.layout_of(launch_mesh.rank_mesh(shape, device=dev))


def lms_rank(rank, world_size, init_method, ckpt_dir, go):
    """Phase 13 on one of the four ranks sharing cuda:0 over gloo, once
    the parent releases it (`lms_wait`): 13a launch.train.main
    (plan_mesh: (1, 4)), 13b the float32 step on (2, 2), 13c its
    checkpoint restored on (1, 4), 13d serve_lm on (1, 4). Returns what
    the parent checks and prints; raises on a failed check here."""
    import torch
    from repro_torch.distributed import checkpoint, elastic, process
    from repro_torch.launch import serve, train
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import tree_abstract
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_map, tree_paths
    from repro_torch.training import sharding as shd
    from repro_torch.training import spmd
    from repro_torch.training import steps as tsteps
    dev = mp_join(rank, world_size, init_method, "gloo")
    out = {}
    try:
        lms_warm(dev)
        pre = lms_predraw(dev)
        lms_wait(go)
        process.barrier()
        # 13a: the launcher, every rank in the mesh plan_mesh gives
        t_part = time.perf_counter()
        argv = lms_train_argv()
        spmd.COUNTER.reset()
        torch.cuda.reset_peak_memory_stats()
        records = []
        t = time.perf_counter()
        state = train.main(argv, records=records)
        main_s = time.perf_counter() - t
        counter = spmd.COUNTER.snapshot()
        mesh = elastic.build_mesh(devices=launch_mesh.rank_devices(dev))
        cfg, _, step, pipe = train.build(train.build_parser().parse_args(
            argv), mesh)
        sds, sh_fn = tsteps.train_state_specs(cfg)
        n_steps = LMS_TRAIN[3]
        a = {"mesh": list(mesh.devices.shape), "records": records,
             "main_s": main_s,
             "counter": lms_counter(counter, sum(r["ms"] for r in records)
                                    / 1e3),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "state_bytes": lms_bytes(state),
             "local_bytes": shd.local_bytes(sds, sh_fn(mesh))}
        data = pipe.get_batch(n_steps, cfg, device=dev)
        a["profiled"] = lms_profiled(
            rank, lambda: float(step(state, data)[1]["loss"]))
        out["13a"] = a
        del state, step, data
        torch.cuda.empty_cache()
        a["wall_s"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # 13b: float32 at full width, 1 layer, on a (2, 2) mesh
        mesh22 = launch_mesh.rank_mesh(LMS_F32_MESH, device=dev)
        spmd.COUNTER.reset()
        torch.cuda.reset_peak_memory_stats()
        run = lms_f32_steps(mesh22, dev)
        counter = spmd.COUNTER.snapshot()
        cfg = run["cfg"]
        sds, sh_fn = tsteps.train_state_specs(cfg)
        bb = {"mesh": list(LMS_F32_MESH), "m0": run["m0"],
              "loss1": run["loss1"], "ms": run["ms"],
              "counter": lms_counter(counter, sum(run["ms"]) / 1e3),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "state_bytes": lms_bytes(run["state"]),
              "local_bytes": shd.local_bytes(sds, sh_fn(mesh22))}
        state, step, data = run["state"], run["step"], run["batch"]
        bb["profiled"] = lms_profiled(
            rank, lambda: float(step(state, data)[1]["loss"]))
        out["13b"] = bb
        bb["wall_s"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # 13c: 13b's state written on (2, 2), restored on (1, 4): the
        # state made whole leaf by leaf on the host (what save(shardings=)
        # gathers), written by rank 0
        t = time.perf_counter()
        written = tree_map(lambda leaf, sh: shd.gather(leaf, sh).cpu(),
                           state, sh_fn(mesh22))
        checkpoint.save(ckpt_dir, 2, written)
        save_s = time.perf_counter() - t
        written = dict(tree_paths(written))
        del state, step, data, run
        torch.cuda.empty_cache()
        mesh14 = launch_mesh.rank_mesh(LMS_CKPT_TO, device=dev)
        sh14 = sh_fn(mesh14)
        like = {"params": tree_abstract(lm.param_specs(cfg)),
                "step": torch.zeros((), dtype=torch.int32)}
        like["opt"] = make_optimizer(cfg.optimizer).init(like["params"])
        t = time.perf_counter()
        step_no, restored = checkpoint.restore(ckpt_dir, like,
                                               shardings=sh14)
        restore_s = time.perf_counter() - t
        pairs = dict(tree_paths(sh14))
        shapes_ok, equal = True, True
        for n, leaf in tree_paths(restored):
            sh = pairs[n]
            shapes_ok &= tuple(leaf.shape) == shd.local_shape(
                sds_shape(sds, n), sh.spec, sh.mesh)
            equal &= torch.equal(shd.gather(leaf, sh).cpu(), written[n])
        check(step_no == 2 and shapes_ok,
              f"13c: restored step {step_no}, block shapes {shapes_ok}")
        check(equal, "13c: the state restored on (1, 4) differs from "
              "the one written on (2, 2)")
        out["13c"] = {"save_s": save_s, "restore_s": restore_s,
                      "bitwise": equal, "leaves": len(pairs)}
        del restored, written
        torch.cuda.empty_cache()
        out["13c"]["wall_s"] = time.perf_counter() - t_part
        t_part = time.perf_counter()

        # 13d: serve_lm on every rank (plan_mesh: (1, 4)), bf16 then f32
        arch, batch, prompt, gen = LMS_SERVE
        cfg = lms_serve_cfg()
        spmd.COUNTER.reset()
        torch.cuda.reset_peak_memory_stats()
        rec = serve.serve_lm(cfg, batch, prompt, gen, device="cuda")
        counter = spmd.COUNTER.snapshot()
        smesh = elastic.build_mesh(devices=launch_mesh.rank_devices(dev))
        c_spec = lm.cache_spec(cfg, batch, prompt + gen)
        dec = tsteps.make_decoder(cfg, batch, prompt + gen, mesh=smesh)
        specs = lm.param_specs(cfg)
        from repro_torch.models.params import tree_sds
        d = {"mesh": list(smesh.devices.shape), "ids": rec["ids"].tolist(),
             **{k: rec[k] for k in ("prefill_ms", "decode_ms_per_token",
                                    "tokens_per_s")},
             "counter": lms_counter(counter, (rec["prefill_ms"] + sum(
                 rec["decode_ms"])) / 1e3),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "state_bytes": lms_bytes(rec["params"])
             + lms_bytes(rec["cache"]),
             "local_bytes": shd.local_bytes(
                 tree_sds(specs), shd.param_shardings(smesh, specs))
             + shd.local_bytes(c_spec, dec.shardings)}
        params, cache, toks = rec["params"], rewind(rec["cache"]), rec["next"]
        d["profiled"] = lms_profiled(
            rank, lambda: dec.step(params, cache, toks))
        del rec, params, cache, toks
        torch.cuda.empty_cache()
        rec = serve.serve_lm(lms_f32_cfg(), batch, prompt,
                             LMS_SERVE_F32_GEN, device="cuda")
        d["ids_f32"] = rec["ids"].tolist()
        d["wall_s"] = time.perf_counter() - t_part
        out["13d"] = d
        del rec
        torch.cuda.empty_cache()
        out.update(lms_rank_split(rank, dev, pre))
        return out
    finally:
        process.finalize()


def lms_rank_split(rank: int, dev, pre: dict) -> dict:
    """13e-13h on one rank (`lms_rank`'s group): the Mamba2, MoE and
    Adafactor steps and batch-1 decode across the four ranks (`pre`:
    13f's blocks, `lms_predraw`)."""
    import torch
    from repro_torch.distributed import elastic
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve, train
    from repro_torch.training import sharding as shd
    from repro_torch.training import spmd
    from repro_torch.training import steps as tsteps
    out = {}

    def begin():
        spmd.COUNTER.reset()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    # 13e: mamba2-130m, the launcher at full depth, then serving
    t_part = time.perf_counter()
    argv = lms_mamba_argv()
    begin()
    records = []
    state = train.main(argv, records=records)
    counter = spmd.COUNTER.snapshot()
    mesh = elastic.build_mesh(devices=launch_mesh.rank_devices(dev))
    cfg, _, step, pipe = train.build(train.build_parser().parse_args(argv),
                                     mesh)
    sds, sh_fn = tsteps.train_state_specs(cfg)
    e = {"mesh": list(mesh.devices.shape), "records": records,
         "counter": lms_counter(counter, sum(r["ms"] for r in records)
                                / 1e3),
         "peak_gb": peak_gb(), "state_bytes": lms_bytes(state),
         "local_bytes": shd.local_bytes(sds, sh_fn(mesh))}
    data = pipe.get_batch(LMS_MAMBA[3], cfg, device=dev)
    e["profiled"] = lms_profiled(
        rank, lambda: float(step(state, data)[1]["loss"]))
    del state, step, data
    torch.cuda.empty_cache()
    b, prompt, gen = LMS_MAMBA_SERVE
    begin()
    rec = serve.serve_lm(lms_mamba_serve_cfg(), b, prompt, gen,
                         device="cuda")
    e["serve"] = {"ids_f32": rec["ids"].tolist(), "counter": lms_counter(
        spmd.COUNTER.snapshot(),
        (rec["prefill_ms"] + sum(rec["decode_ms"])) / 1e3),
        **{k: rec[k] for k in ("prefill_ms", "decode_ms_per_token",
                               "tokens_per_s")}}
    del rec
    torch.cuda.empty_cache()
    e["wall_s"] = time.perf_counter() - t_part
    out["13e"] = e

    # 13f, 13g: a train step at the published width on (2, 2)
    mesh22 = launch_mesh.rank_mesh(LMS_WIDE_MESH, device=dev)
    for phase in LMS_WIDE:
        t_part = time.perf_counter()
        begin()
        run = lms_wide_steps(phase, mesh22, dev,
                             pre if phase == "13f" else None, rank == 0)
        pre = None
        counter = spmd.COUNTER.snapshot()
        sds, sh_fn = tsteps.train_state_specs(run["cfg"])
        w = {"mesh": list(LMS_WIDE_MESH), "m0": run["m0"],
             "loss1": run["loss1"], "ms": run["ms"],
             "draw_s": run["draw_s"],
             "opt": run.get("opt") if rank == 0 else None,
             "counter": lms_counter(counter, sum(run["ms"]) / 1e3),
             "peak_gb": peak_gb(), "state_bytes": lms_bytes(run["state"]),
             "local_bytes": shd.local_bytes(sds, sh_fn(mesh22)),
             "profiled": run["profiled"]}
        del run
        torch.cuda.empty_cache()
        w["wall_s"] = time.perf_counter() - t_part
        out[phase] = w

    # 13h: batch-1 decode, the KV slots over 'data'
    t_part = time.perf_counter()
    mesh41 = launch_mesh.rank_mesh(LMS_LONG_MESH, device=dev)
    h = {"mesh": list(LMS_LONG_MESH)}
    for dtype in ("float32", "bfloat16"):
        begin()
        r = lms_long_decode(dtype, mesh41, dev,
                            rank if dtype == "bfloat16" else -1)
        leg = {"ids": r["ids"], "ms": r["ms"], "counter": lms_counter(
            spmd.COUNTER.snapshot(), sum(r["ms"]) / 1e3),
            "peak_gb": peak_gb(), "state_bytes": r["state_bytes"],
            "local_bytes": r["local_bytes"]}
        if dtype == "float32":
            leg["logits"] = r["logits"]
            h["f32"] = leg
        else:
            h.update(leg, profiled=r["profiled"])
        del r
        torch.cuda.empty_cache()
    h["wall_s"] = time.perf_counter() - t_part
    out["13h"] = h
    return out


def sds_shape(sds, name: str) -> tuple:
    """The global shape of leaf `name` of a `TensorSpec` tree."""
    from repro_torch.optim.optimizers import tree_paths
    return tuple(dict(tree_paths(sds))[name].shape)


def lms_line(phase: str, card: str, ranks: list, extra: dict) -> dict:
    """One `lm_sharded` line from the ranks' results of `phase`."""
    rows = [r[phase] for r in ranks]
    r0 = rows[0]
    line = {"phase": phase, "card": card, "ranks": len(rows),
            "backend": "gloo", "mesh": r0["mesh"], **extra,
            "peak_gb_per_rank": [r["peak_gb"] for r in rows],
            "state_bytes_per_rank": [r["state_bytes"] for r in rows],
            "local_bytes": r0["local_bytes"],
            "coll_bytes_rank0": r0["counter"]["bytes"],
            "coll_calls_rank0": r0["counter"]["calls"],
            "wall_s_per_rank": [r["wall_s"] for r in rows],
            "gloo_share_per_rank": [r["counter"]["gloo_share"]
                                    for r in rows],
            "staging_share_per_rank": [r["counter"]["staging_share"]
                                       for r in rows]}
    prof = r0.get("profiled")
    if prof is not None:
        line["idle_share_rank0"] = prof["idle_share"]
        line["profiled_wall_ms_rank0"] = prof["wall_ms"]
        line["top_device_ops_rank0"] = prof["top_device_ops"]
    return line


def lms_dryrun_counts() -> dict:
    """The dry-run's per-step collective bytes of 13a, 13b and 13d's
    steps on their meshes (`launch.dryrun.count_collectives`)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh
    axes = ("data", "model")
    arch, batch, seq, _ = LMS_TRAIN
    _, _, b, s = LMS_F32
    return {
        "13a": dryrun.count_collectives(configs.get(arch), "train", batch,
                                        seq, abstract_mesh((1, 4), axes),
                                        chunk=min(seq, 2048)),
        "13b": dryrun.count_collectives(lms_f32_cfg(), "train", b, s,
                                        abstract_mesh(LMS_F32_MESH, axes),
                                        chunk=s),
        "13d": dryrun.count_collectives(
            lms_serve_cfg(), "decode", LMS_SERVE[1], sum(LMS_SERVE[2:]),
            abstract_mesh((1, 4), axes)),
        "13e": dryrun.count_collectives(
            configs.get(LMS_MAMBA[0]), "train", LMS_MAMBA[1], LMS_MAMBA[2],
            abstract_mesh((1, 4), axes), chunk=min(LMS_MAMBA[2], 2048)),
        "13e_serve": dryrun.count_collectives(
            lms_mamba_serve_cfg(), "decode", LMS_MAMBA_SERVE[0], sum(LMS_MAMBA_SERVE[1:]),
            abstract_mesh((1, 4), axes)),
        **{p: dryrun.count_collectives(
            lms_wide_cfg(p), "train", *LMS_WIDE_BATCH,
            abstract_mesh(LMS_WIDE_MESH, axes), chunk=LMS_WIDE_BATCH[1])
           for p in LMS_WIDE},
        **{f"13h_{d}": dryrun.count_collectives(
            lms_long_cfg(d), "decode", 1, LMS_LONG[1],
            abstract_mesh(LMS_LONG_MESH, axes))
           for d in ("float32", "bfloat16")}}


def lms_one_process(dev) -> tuple:
    """The one-process runs phase 13 holds the ranks against: 13a's
    launcher records, 13b's metrics, 13d's bf16 and float32 serving."""
    import gc

    import torch
    from repro_torch.launch import serve, train
    ref_records = []
    train.main(lms_train_argv(), records=ref_records)
    gc.collect()
    torch.cuda.empty_cache()
    ref_b = lms_f32_steps(None, dev)
    ref_b = {k: ref_b[k] for k in ("m0", "loss1", "ms")}
    gc.collect()
    torch.cuda.empty_cache()
    _, batch, prompt, gen = LMS_SERVE
    ref_d = serve.serve_lm(lms_serve_cfg(), batch, prompt, gen,
                           device="cuda")
    ref_d = {k: ref_d[k] for k in ("ids", "prefill_ms",
                                   "decode_ms_per_token", "tokens_per_s")}
    ref_d32 = serve.serve_lm(lms_f32_cfg(), batch, prompt,
                             LMS_SERVE_F32_GEN, device="cuda")["ids"]
    gc.collect()
    torch.cuda.empty_cache()
    return ref_records, ref_b, ref_d, ref_d32, lms_one_process_split(dev)


def lms_one_process_split(dev) -> dict:
    """13e-13h's one-process runs: the launcher's records and the float32
    serving (13e), the float32 steps (13f, 13g), the decodes (13h), and
    their seconds."""
    import gc

    import torch
    from repro_torch.launch import serve, train

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = {"13e": {"records": []}}
    train.main(lms_mamba_argv(), records=out["13e"]["records"])
    free()
    b, prompt, gen = LMS_MAMBA_SERVE
    rec = serve.serve_lm(lms_mamba_serve_cfg(), b, prompt, gen,
                         device="cuda")
    out["13e"].update({k: rec[k] for k in ("ids", "prefill_ms",
                                           "decode_ms_per_token",
                                           "tokens_per_s")})
    del rec
    free()
    for phase in LMS_WIDE:
        run = lms_wide_steps(phase, None, dev)
        out[phase] = {k: run.get(k) for k in ("m0", "loss1", "ms", "opt",
                                              "draw_s", "dropped_share")}
        del run
        free()
    for dtype in ("float32", "bfloat16"):
        r = lms_long_decode(dtype, None, dev)
        out["13h", dtype] = {k: r[k] for k in ("ids", "logits", "ms")}
        del r
        free()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_lm_sharded(dev) -> dict:
    """Phase 13, the sharded LM step across torch.distributed ranks: four
    ranks spawned on cuda:0 over gloo under one join deadline (13a-13d,
    `lms_rank`); they start up while the one-process runs they are held
    against use the card, and run once those are done. Checks: 13a losses within 2e-2 relative; 13b loss,
    grad_norm and the next loss within 1e-4 x max(1, |ref|); 13c bitwise
    (in the rank); 13d float32 ids equal; 13e losses within 2e-2
    relative and float32 ids equal; 13f and 13g loss, ce, aux, grad_norm
    and the next loss within 1e-4 x max(1, |ref|), 13g's Adafactor state
    after the second update within 1e-4 of each leaf's norm; 13h float32
    ids equal and logits within 1e-4; every rank's state bytes equal to
    local_bytes; the bytes each rank counted equal to the dry-run's count
    of the cell times the steps. One `lm_sharded` line per run."""
    import gc

    import torch
    from repro_torch.distributed import process
    t0 = time.perf_counter()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_lms_")
    go = os.path.join(ckpt, "go")
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            # the ranks start up (imports, their CUDA contexts) while the
            # one-process runs they are held against use the card alone
            spawned = pool.submit(process.launch, lms_rank, LMS_RANKS,
                                  (ckpt, go), timeout_s=LMS_DEADLINE_S)
            released = "abort"
            try:
                refs = lms_one_process(dev)
                released = "run"
            finally:
                with open(go + ".tmp", "w") as f:
                    f.write(released)
                os.replace(go + ".tmp", go)
            t_ref = time.perf_counter() - t0
            t_spawn = time.perf_counter()
            counted = pool.submit(lms_dryrun_counts)  # on the host, meanwhile
            ranks = spawned.result()
            dry = counted.result()
            t_spawn = time.perf_counter() - t_spawn
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lms_report(card, ranks, refs, dry)
    split = sum(r[p]["wall_s"] for r in ranks[:1]
                for p in ("13e", "13f", "13g", "13h"))
    log(f"phase 13 lm sharded: {time.perf_counter() - t0:.1f} s "
        f"(one-process runs {t_ref:.1f} s, 13e-13h's "
        f"{refs[-1]['wall_s']:.1f}; the spawn {t_spawn:.1f} s, 13e-13h's "
        f"{split:.1f} on rank 0)")
    return {"spawn_s": t_spawn}


def lms_report(card: str, ranks: list, refs: tuple, dry: dict) -> None:
    """Phase 13's checks in the parent and its `lm_sharded` lines: the
    ranks' results against the one-process runs `refs` and the dry-run's
    per-step counts `dry`."""
    ref_records, ref_b, ref_d, ref_d32, split = refs
    for r in ranks:
        for p in ("13a", "13b", "13d"):
            check(r[p]["state_bytes"] == r[p]["local_bytes"],
                  f"{p}: a rank holds {r[p]['state_bytes']} bytes, "
                  f"local_bytes {r[p]['local_bytes']}")
    # 13a
    _, tb, ts, n_steps = LMS_TRAIN
    a0 = ranks[0]["13a"]
    check(a0["mesh"] == [1, 4], f"13a: plan_mesh gave {a0['mesh']}")
    losses = [[x["loss"] for x in r["13a"]["records"]] for r in ranks]
    want = [x["loss"] for x in ref_records]
    rel = max(abs(g - w) / abs(w) for got in losses
              for g, w in zip(got, want))
    check(all(len(x) == len(want) for x in losses) and rel <= 2e-2,
          f"13a: losses {losses} against the one-process {want}")
    for p, n in (("13a", n_steps), ("13b", 2), ("13d", sum(LMS_SERVE[2:]))):
        got, cnt = ranks[0][p]["counter"]["bytes"], dry[p]
        check(all(r[p]["counter"]["bytes"] == got for r in ranks)
              and all(got[k] == n * cnt[k] for k in cnt),
              f"{p}: counted {got} over {n} steps, the dry-run's "
              f"{cnt} a step")
    step_ms = [r["13a"]["records"][-1]["ms"] for r in ranks]
    log("lm_sharded " + json.dumps(lms_line("13a", card, ranks, {
        "arch": LMS_TRAIN[0], "batch": tb, "seq": ts, "steps": n_steps,
        "dryrun_coll_bytes_per_step": dry["13a"],
        "dtype": "bfloat16", "losses": losses[0],
        "one_process_losses": want, "loss_rel_err": rel,
        "ms_per_step_per_rank": step_ms,
        "tokens_per_s": tb * ts / (max(step_ms) / 1e3),
        "one_process_ms": ref_records[-1]["ms"],
        "one_process_tokens_per_s": tb * ts / (ref_records[-1]["ms"] / 1e3),
        "main_s_per_rank": [r["13a"]["main_s"] for r in ranks]})))
    # 13b
    b0 = ranks[0]["13b"]
    for k in ("loss", "grad_norm", "ce"):
        check(lms_close(b0["m0"][k], ref_b["m0"][k], 1e-4),
              f"13b: {k} {b0['m0'][k]} against {ref_b['m0'][k]}")
    check(lms_close(b0["loss1"], ref_b["loss1"], 1e-4),
          f"13b: next loss {b0['loss1']} against {ref_b['loss1']}")
    _, layers, bb, bs = LMS_F32
    log("lm_sharded " + json.dumps(lms_line("13b", card, ranks, {
        "arch": LMS_F32[0], "layers": layers, "batch": bb, "seq": bs,
        "dryrun_coll_bytes_per_step": dry["13b"],
        "dtype": "float32", "metrics": b0["m0"], "next_loss": b0["loss1"],
        "one_process_metrics": ref_b["m0"],
        "one_process_next_loss": ref_b["loss1"],
        "ms_per_step_per_rank": [r["13b"]["ms"][-1] for r in ranks],
        "tokens_per_s": bb * bs / (max(r["13b"]["ms"][-1]
                                       for r in ranks) / 1e3),
        "one_process_ms": ref_b["ms"][-1]})))
    # 13c
    c0 = ranks[0]["13c"]
    check(c0["bitwise"], "13c: restored state differs")
    log("lm_sharded " + json.dumps({
        "phase": "13c", "card": card, "from_mesh": list(LMS_F32_MESH),
        "to_mesh": list(LMS_CKPT_TO), "leaves": c0["leaves"],
        "bitwise": True, "save_s_per_rank": [r["13c"]["save_s"]
                                             for r in ranks],
        "restore_s_per_rank": [r["13c"]["restore_s"] for r in ranks],
        "wall_s_per_rank": [r["13c"]["wall_s"] for r in ranks]}))
    # 13d
    arch, batch, prompt, gen = LMS_SERVE
    d0 = ranks[0]["13d"]
    check(all(r["13d"]["ids"] == d0["ids"] for r in ranks)
          and all(r["13d"]["ids_f32"] == d0["ids_f32"] for r in ranks),
          "13d: the ranks returned different ids")
    check(d0["ids_f32"] == ref_d32.tolist(),
          f"13d: float32 ids {d0['ids_f32']} against the one-process "
          f"{ref_d32.tolist()}")
    same = [x == y for gr, wr in zip(d0["ids"], ref_d["ids"].tolist())
            for x, y in zip(gr, wr)]
    log("lm_sharded " + json.dumps(lms_line("13d", card, ranks, {
        "arch": arch, "layers": LMS_SERVE_LAYERS, "batch": batch,
        "prompt_len": prompt, "gen": gen,
        "dryrun_coll_bytes_per_step": dry["13d"],
        "dtype": "bfloat16",
        **{k: d0[k] for k in ("prefill_ms", "decode_ms_per_token",
                              "tokens_per_s")},
        "one_process": {k: ref_d[k] for k in ("prefill_ms",
                                              "decode_ms_per_token",
                                              "tokens_per_s")},
        "bf16_ids_equal_share": sum(same) / len(same),
        "f32_layers": LMS_F32[1], "f32_gen": LMS_SERVE_F32_GEN,
        "f32_ids_equal": True})))
    lms_report_split(card, ranks, split, dry)


def lms_report_split(card: str, ranks: list, ref: dict, dry: dict) -> None:
    """13e-13h's checks in the parent and their `lm_sharded` lines."""
    for r in ranks:
        for p in ("13e", "13f", "13g", "13h"):
            check(r[p]["state_bytes"] == r[p]["local_bytes"],
                  f"{p}: a rank holds {r[p]['state_bytes']} bytes, "
                  f"local_bytes {r[p]['local_bytes']}")
        check(r["13h"]["f32"]["state_bytes"]
              == r["13h"]["f32"]["local_bytes"],
              "13h: the float32 leg's state bytes differ from local_bytes")

    def counted(p, got, n, want):
        check(all(got(r) == got(ranks[0]) for r in ranks)
              and all(got(ranks[0])[k] == n * want[k] for k in want),
              f"{p}: counted {got(ranks[0])} over {n} steps, the "
              f"dry-run's {want} a step")

    # 13e
    arch, tb, ts, n_steps = LMS_MAMBA
    e0 = ranks[0]["13e"]
    check(e0["mesh"] == [1, 4], f"13e: plan_mesh gave {e0['mesh']}")
    losses = [[x["loss"] for x in r["13e"]["records"]] for r in ranks]
    want = [x["loss"] for x in ref["13e"]["records"]]
    rel = max(abs(g - w) / abs(w) for got in losses
              for g, w in zip(got, want))
    check(all(len(x) == len(want) for x in losses) and rel <= 2e-2,
          f"13e: losses {losses} against the one-process {want}")
    counted("13e", lambda r: r["13e"]["counter"]["bytes"], n_steps,
            dry["13e"])
    counted("13e serving", lambda r: r["13e"]["serve"]["counter"]["bytes"],
            sum(LMS_MAMBA_SERVE[1:]), dry["13e_serve"])
    ids = ref["13e"]["ids"].tolist()
    check(all(r["13e"]["serve"]["ids_f32"] == ids for r in ranks),
          f"13e: float32 ids {e0['serve']['ids_f32']} against the "
          f"one-process {ids}")
    step_ms = [r["13e"]["records"][-1]["ms"] for r in ranks]
    log("lm_sharded " + json.dumps(lms_line("13e", card, ranks, {
        "arch": arch, "batch": tb, "seq": ts,
        "steps": n_steps, "dtype": "bfloat16",
        "dryrun_coll_bytes_per_step": dry["13e"], "losses": losses[0],
        "one_process_losses": want, "loss_rel_err": rel,
        "ms_per_step_per_rank": step_ms,
        "tokens_per_s": tb * ts / (max(step_ms) / 1e3),
        "one_process_ms": ref["13e"]["records"][-1]["ms"],
        "serve_f32": {"layers": LMS_MAMBA_SERVE_LAYERS,
                      "batch": LMS_MAMBA_SERVE[0],
                      "prompt_len": LMS_MAMBA_SERVE[1],
                      "gen": LMS_MAMBA_SERVE[2], "ids_equal": True,
                      "dryrun_coll_bytes_per_step": dry["13e_serve"],
                      "coll_bytes_rank0": e0["serve"]["counter"]["bytes"],
                      "gloo_share_rank0":
                          e0["serve"]["counter"]["gloo_share"],
                      **{k: e0["serve"][k] for k in (
                          "prefill_ms", "decode_ms_per_token",
                          "tokens_per_s")},
                      "one_process": {k: ref["13e"][k] for k in (
                          "prefill_ms", "decode_ms_per_token",
                          "tokens_per_s")}}})))
    # 13f, 13g
    for p in LMS_WIDE:
        w0, want = ranks[0][p], ref[p]
        for k in ("loss", "ce", "aux", "grad_norm"):
            check(lms_close(w0["m0"][k], want["m0"][k], 1e-4),
                  f"{p}: {k} {w0['m0'][k]} against {want['m0'][k]}")
        check(lms_close(w0["loss1"], want["loss1"], 1e-4),
              f"{p}: next loss {w0['loss1']} against {want['loss1']}")
        counted(p, lambda r: r[p]["counter"]["bytes"], 2, dry[p])
        opt_err = None
        if want["opt"] is not None:     # Adafactor's moments, read back
            got = w0["opt"]
            check(set(got) == set(want["opt"]),
                  f"{p}: the optimizer state's leaves differ")
            opt_err = max(float((got[n] - x).norm()
                                / x.norm().clamp_min(1e-30))
                          for n, x in want["opt"].items())
            check(opt_err <= 1e-4, f"{p}: the optimizer state after the "
                  f"second update is {opt_err} off the one process's")
        arch, layers = LMS_WIDE[p]
        b, s = LMS_WIDE_BATCH
        log("lm_sharded " + json.dumps(lms_line(p, card, ranks, {
            "arch": arch, "layers": layers, "batch": b, "seq": s,
            "dtype": "float32", "optimizer": lms_wide_cfg(p).optimizer,
            "dryrun_coll_bytes_per_step": dry[p], "metrics": w0["m0"],
            "next_loss": w0["loss1"], "one_process_metrics": want["m0"],
            "one_process_next_loss": want["loss1"],
            "ms_per_step_per_rank": [r[p]["ms"][-1] for r in ranks],
            "tokens_per_s": b * s / (max(r[p]["ms"][-1] for r in ranks)
                                     / 1e3),
            "one_process_ms": want["ms"][-1],
            "one_process_dropped_share": want["dropped_share"],
            "opt_state_rel_err_after_update_2": opt_err,
            "draw_s_per_rank": [r[p]["draw_s"] for r in ranks],
            "draw": "host, leaf by leaf" if p == "13f" else "card",
            "one_process_draw_s": want["draw_s"],
            "one_process_draw": "host, whole tree" if p == "13f"
            else "card", **lms_host_bytes(p)})))
    # 13h
    h0 = ranks[0]["13h"]
    f32, bf16 = ref["13h", "float32"], ref["13h", "bfloat16"]
    check(all(r["13h"]["f32"]["ids"] == f32["ids"] for r in ranks),
          f"13h: float32 ids {h0['f32']['ids']} against the one-process "
          f"{f32['ids']}")
    err = float((h0["f32"]["logits"] - f32["logits"]).abs().max())
    check(err <= 1e-4, f"13h: float32 logits {err} off the one process's")
    check(all(r["13h"]["ids"] == h0["ids"] for r in ranks),
          "13h: the ranks returned different bf16 ids")
    counted("13h float32", lambda r: r["13h"]["f32"]["counter"]["bytes"],
            LMS_LONG[3], dry["13h_float32"])
    counted("13h", lambda r: r["13h"]["counter"]["bytes"], LMS_LONG[3],
            dry["13h_bfloat16"])
    same = [x == y for x, y in zip(h0["ids"], bf16["ids"])]
    arch, slots, length, n_tok = LMS_LONG
    log("lm_sharded " + json.dumps(lms_line("13h", card, ranks, {
        "arch": arch, "layers": lms_long_cfg("bfloat16").n_layers,
        "slots": slots, "length": length, "tokens": n_tok,
        "dtype": "bfloat16", "dryrun_coll_bytes_per_step":
            dry["13h_bfloat16"],
        "ms_per_token_rank0": statistics.median(h0["ms"][:-1]),
        "profiled_token_ms_rank0": h0["ms"][-1],
        "one_process_ms_per_token": statistics.median(bf16["ms"]),
        "bf16_ids_equal_share": sum(same) / len(same),
        "f32": {"layers": LMS_LONG_LAYERS["float32"], "ids_equal": True,
                "logits_max_abs_err": err,
                "ms_per_token_rank0": statistics.median(h0["f32"]["ms"]),
                "one_process_ms_per_token": statistics.median(f32["ms"]),
                "dryrun_coll_bytes_per_step": dry["13h_float32"],
                "coll_bytes_rank0": h0["f32"]["counter"]["bytes"],
                "gloo_share_rank0": h0["f32"]["counter"]["gloo_share"],
                "peak_gb_rank0": h0["f32"]["peak_gb"]}})))


def time_kernels() -> None:
    """K1, K2 and K3 per paper op at 512^3 x 8, as one JSON line.

    K1 on one prepared job at dw8.nf2.fused (one plan for both checkouts),
    K2 and K3 as ops.spatial and ops.ghostzone with default parameters, as
    phase 5 times them.
    Uses only interfaces the port has had since K2 and K3 were ported, so
    it times an earlier checkout as well.
    """
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    out = {"mwd": {}, "sweep": {}, "fused": {}}
    for name, spec in st.SPECS.items():
        state, coeffs = st.make_problem(spec, MAIN_GRID, seed=0, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        out["mwd"][name] = k1_ms(spec, state, arrays, scalars,
                                 dict(d_w=8, n_f=2, fused=True))
        for kernel, fn in (("sweep", ops.spatial), ("fused", ops.ghostzone)):
            fn(spec, state, coeffs, MAIN_STEPS)     # warm-up
            out[kernel][name] = cuda_ms(
                lambda: fn(spec, state, coeffs, MAIN_STEPS), TIMING_REPS)
        del state, coeffs, arrays
        torch.cuda.empty_cache()
    print("kernel_ms " + json.dumps(out), flush=True)
    print("k1_points " + json.dumps(k1_calibration_points(dev)), flush=True)


def sweep_fused() -> None:
    """K3 at every tile plan that fits, per paper op at 512^3 x 8 steps.

    Times ops.ghostzone (defaults t_block=4, bz=by=16) with the kernel's own
    choice replaced by each (layout, bx >= 16, threads; one and two planes
    a step at the chosen tile where it reads level 0 in place and hoists no
    coefficient load) in turn, each
    held bitwise against the kernel's own choice; one `k3_plan` JSON line
    per plan. The measurement behind `stencil_fused.choose_tile`.
    """
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_fused as fu
    dev = torch.device("cuda", 0)
    own = fu.choose_tile
    tb, by = GHOSTZONE_DEFAULTS["t_block"], GHOSTZONE_DEFAULTS["by"]
    for name, spec in st.SPECS.items():
        state, coeffs = st.make_problem(spec, MAIN_GRID, seed=0, device=dev)
        want = ops.ghostzone(spec, state, coeffs, MAIN_STEPS)
        chosen = own(spec, tb, by, MAIN_GRID[2], 4)
        plans = [fu.tile_layout(spec, tb, by, bx, 4, layout=layout,
                                threads=threads, planes=planes)
                 for layout, bx, threads in itertools.product(
                     ("all-rings", "cur-in-place"), fu.BX_CHOICES[:-1],
                     (256, 512, 1024))
                 for planes in ((1, 2) if (layout, bx, threads) == (
                     chosen.layout, chosen.bx, chosen.threads)
                     and layout == "cur-in-place" and chosen.hoist == 0
                     else (1,))]
        plans = [p for p in dict.fromkeys(plans) if p.fits]
        for plan in plans:
            fu.choose_tile = lambda *a, plan=plan: plan
            try:
                got = ops.ghostzone(spec, state, coeffs, MAIN_STEPS)
                check(all(same(a, b) for a, b in zip(got, want)),
                      f"{name} {plan}: K3 != its own choice")
                del got
                ms = cuda_ms(lambda: ops.ghostzone(spec, state, coeffs,
                                                   MAIN_STEPS), 3)
                cfg = fu.kernel_config(spec, state[0], tb)
            finally:
                fu.choose_tile = own
            log("k3_plan " + json.dumps({
                "op": name, "layout": plan.layout, "bx": plan.bx,
                "planes": plan.planes, "threads": plan.threads,
                "hoist": plan.hoist,
                "smem_bytes": plan.smem_bytes, "resident": cfg["resident"],
                "ms": ms, "chosen": plan == chosen}))
        del state, coeffs, want
        torch.cuda.empty_cache()


def k2_plans(spec, shape, elem):
    """Stage one of `sweep_sweep` for one op: the kernel's own choice and
    every (x tile, y tile, threads, planes loaded ahead) that fits at its
    chunk and prefetch."""
    from repro_torch.kernels import stencil_sweep as sw
    own = sw.choose_tile(spec, shape, 8, elem)
    plans = []
    for tx, ty, threads, ahead in itertools.product(
            sw.TX_CHOICES, (4, 8, 16, 32), (128, 256, 512, 1024), (1, 2)):
        try:
            plan = sw.tile_layout(spec, ty, tx, elem, threads=threads,
                                  chunk=own.chunk, ahead=ahead,
                                  prefetch=own.prefetch)
        except ValueError:              # cells that do not cover the tile
            continue
        if plan.fits:
            plans.append(plan)
    return own, list(dict.fromkeys(plans))


def k2_variants(spec, best, elem):
    """Stage two of `sweep_sweep`: the fastest plan of stage one at every
    chunk (whole multiples of ops.spatial's bz = 8), loads ahead and L2
    prefetch distance, taps in place instead of the ring and, where its
    instance hoists coefficient loads, the instance without hoisting."""
    import dataclasses
    from repro_torch.kernels import stencil_sweep as sw
    out = []
    for chunk, ahead, prefetch in itertools.product(
            (16, 32, 64, 128, 256), (1, 2), (0, 2, 4)):
        plan = sw.tile_layout(spec, best.ty, best.tx, elem,
                              threads=best.threads, chunk=chunk, ahead=ahead,
                              prefetch=prefetch)
        if plan.fits:
            out.append(plan)
    try:
        out.append(sw.tile_layout(spec, best.ty, best.tx, elem,
                                  threads=best.threads, chunk=best.chunk,
                                  copy="in-place", prefetch=best.prefetch))
    except ValueError:                  # its four cells do not cover the tile
        pass
    h = best.tx // 4
    if (best.hoist and best.tx % 128 == 0 and h <= best.threads
            and best.threads % h == 0):
        out.append(dataclasses.replace(best, hoist=0, cells=4))
    return out


def sweep_sweep() -> None:
    """K2 at its tile plans, per paper op at 512^3 x 8 steps.

    Times ops.spatial (default bz = 8) with the kernel's own choice
    replaced by each plan of `k2_plans`, then by each of `k2_variants` of
    the fastest, each held bitwise against the kernel's own choice; one
    `k2_plan` JSON line per plan, with its share of the compulsory bound,
    and one `k2_best` line per op. The measurement behind
    `stencil_sweep.choose_tile`.
    """
    import torch
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_sweep as sw
    dev = torch.device("cuda", 0)
    own = sw.choose_tile
    for name, spec in st.SPECS.items():
        state, coeffs = st.make_problem(spec, MAIN_GRID, seed=0, device=dev)
        want = ops.spatial(spec, state, coeffs, MAIN_STEPS)
        chosen, plans = k2_plans(spec, MAIN_GRID, 4)
        b_ms, _ = bound(spec, MAIN_GRID, MAIN_STEPS, passes=MAIN_STEPS,
                        outputs=1)
        timed_plans = {}

        def time_plan(plan):
            sw.choose_tile = lambda *a, plan=plan: plan
            try:
                got = ops.spatial(spec, state, coeffs, MAIN_STEPS)
                check(all(same(a, b) for a, b in zip(got, want)),
                      f"{name} {plan}: K2 != its own choice")
                del got
                ms = cuda_ms(lambda: ops.spatial(spec, state, coeffs,
                                                 MAIN_STEPS), 3)
                cfg = sw.kernel_config(spec, state[0])
            finally:
                sw.choose_tile = own
            timed_plans[plan] = ms
            log("k2_plan " + json.dumps({
                "op": name, "ty": plan.ty, "tx": plan.tx,
                "threads": plan.threads, "chunk": plan.chunk,
                "ahead": plan.ahead, "copy": plan.copy,
                "prefetch": plan.prefetch,
                "hoist": plan.hoist,
                "cells": plan.cells, "smem_bytes": plan.smem_bytes,
                "resident": cfg["resident"], "ms": ms,
                "share": b_ms / ms, "chosen": plan == chosen}))

        for plan in dict.fromkeys([chosen] + plans):
            time_plan(plan)
        best = min(timed_plans, key=timed_plans.get)
        for plan in k2_variants(spec, best, 4):
            if plan not in timed_plans:
                time_plan(plan)
        best = min(timed_plans, key=timed_plans.get)
        log(f"k2_best {name}: {best} {timed_plans[best]:.3f} ms, chosen "
            f"{timed_plans[chosen]:.3f} ms")
        del state, coeffs, want
        torch.cuda.empty_cache()


def compare(other: Path) -> None:
    """K1, K2 and K3 of the checkout at `other` and of this one, in turns
    on one card.

    Order: other, this, this, other; each in its own process, which builds
    its own checkout's kernels.
    """
    from repro_torch.core import models
    runs, k1_points = [], {"other": [], "this": []}
    for root, side in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                       (other, "other")):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--time-kernels", str(root)], capture_output=True, text=True,
            timeout=1200)
        check(proc.returncode == 0, f"kernel timing of {root} failed:\n"
                                    f"{proc.stdout}\n{proc.stderr}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("kernel_ms ")][-1]
        runs.append((side, json.loads(line[len("kernel_ms "):])))
        log(f"compare {side} {root}: {json.dumps(runs[-1][1])}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("k1_points ")][-1]
        k1_points[side] += json.loads(line[len("k1_points "):])
    for kernel, times in runs[0][1].items():
        for name in times:
            other_ms = [r[kernel][name] for side, r in runs
                        if side == "other"]
            this_ms = [r[kernel][name] for side, r in runs if side == "this"]
            log(f"compare {kernel} {name}: other {other_ms} this {this_ms} "
                f"speedup {min(other_ms) / max(this_ms):.3f}-"
                f"{max(other_ms) / min(this_ms):.3f}x")
    # K1's phase costs fitted to each tree's K1 times (this tree's model
    # counts the phases of both: K1's loop is the one both run)
    for side, points in k1_points.items():
        rep = models.k1_residuals(k1_fit_points(points))
        log(f"compare phase fit {side}: " + json.dumps({
            "points": rep["n"], "costs_s": rep["calibration"]["costs_s"],
            "max_abs_rel_err": rep["max_abs_rel_err"],
            "mean_abs_rel_err": rep["mean_abs_rel_err"]}))


def calibrate(dest: Path) -> None:
    """The measurements behind the spec's energy constants and K1 phase
    costs: the energy phase, the fit twin, and K1 at every fused plan it
    launches up to d_w 16 and the per-row plans of CALIBRATION_PLANS, at
    256^3 and 512^3, written to `dest`/calibration.json with the
    calibrated spec beside it (`dest`/h100-sxm.json)."""
    import torch
    from repro_torch.core import models, specs
    from repro_torch.core import stencils as st
    dev = torch.device("cuda", 0)
    phase_setup()
    from repro_torch.core import autotune
    out = {"energy": phase_energy(dev, Nvml(dev)),
           "fit_twin": check_fit_twin(dev)}
    t0 = time.perf_counter()
    # every fused plan K1 launches at 256 columns up to d_w 16, and the
    # per-row twins of CALIBRATION_PLANS
    wide = {}
    for r in CALIBRATION_PLANS:
        spec = next(s for s in st.SPECS.values() if s.radius == r)
        wide[r] = tuple((p.d_w, p.n_f, True) for p in autotune._fitting_plans(
            spec, 256, chip(), d_w_cap=16) if p.fused) + tuple(
            q for q in CALIBRATION_PLANS[r] if not q[2])
    out["k1"] = k1_calibration_points(dev, wide, sizes=(256, 512))
    log(f"k1 calibration points: {len(out['k1'])} in "
        f"{time.perf_counter() - t0:.1f} s")
    for p in out["k1"]:
        log("k1_point " + json.dumps(p))
    # the spec with the measured constants: K1's phase costs by
    # models.fit_k1 over these points, the energy phase's three constants,
    # each to four significant digits
    fit = models.fit_k1(k1_fit_points(out["k1"]))
    measured = {**fit.costs_s, **{f: out["energy"]["measured"][f] for f in (
        "static_power_w", "joules_per_flop", "joules_per_hbm_byte")}}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    spec_file = ROOT / "src" / "repro_torch" / "specs" / "h100-sxm.json"
    raw = json.loads(spec_file.read_text())
    raw.update({f: float(f"{v:.4g}") for f, v in measured.items()})
    raw["source"] = raw["source"].split(CALIBRATED_BY)[0].rstrip() + (
        f" {CALIBRATED_BY} on {card}: K1's phase costs by models.fit_k1 over "
        f"{fit.n_points} K1 times (max |residual| {fit.max_rel_err:.0%}); "
        f"the energy constants through NVML (idle, a device copy_, an f32 "
        f"GEMM).")
    specs.validate_spec_dict(raw)
    out["fit_k1"] = dataclasses.asdict(fit)
    out["spec"] = raw
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "calibration.json").write_text(json.dumps(out, indent=1))
    (dest / "h100-sxm.json").write_text(json.dumps(raw, indent=2) + "\n")
    log("calibrated_spec " + json.dumps(raw))


def main() -> int:
    args = sys.argv[1:]
    root = ROOT
    if args[:1] == ["--time-kernels"] and len(args) == 2:
        root = Path(args[1]).resolve()
    elif args[:1] == ["--compare"] and len(args) == 2:
        pass
    elif args[:1] == ["--calibrate"] and len(args) == 2:
        pass
    elif args and args not in (["--sweep-k3"], ["--sweep-k2"]):
        print("usage: chip_smoke.py [--compare OTHER_CHECKOUT | --sweep-k3 "
              "| --sweep-k2 | --calibrate OUT_DIR]", file=sys.stderr)
        return 2
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    if args[:1] == ["--time-kernels"]:
        time_kernels()
        return 0
    if args[:1] == ["--compare"]:
        compare(Path(args[1]).resolve())
        return 0
    if args == ["--sweep-k3"]:
        sweep_fused()
        return 0
    if args == ["--sweep-k2"]:
        sweep_sweep()
        return 0
    if args[:1] == ["--calibrate"]:
        calibrate(Path(args[1]).resolve())
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    # the run's own plan registry: plan="auto" resolves from what the tune
    # phase measures, never from a file left by another run
    plans = tempfile.mkdtemp(prefix="chip_smoke_plans_")
    os.environ["REPRO_TORCH_PLAN_REGISTRY"] = os.path.join(plans, "plans.json")
    try:
        ptxas = phase_setup()
        phase_spec(dev, ptxas)
        phase_energy(dev, Nvml(dev))
        tally = Tally()
        phase_kernel_checks(tally, dev)
        phase_calibration(dev)
        phase_tune(dev)
        rows = phase_main_path(tally, dev, ptxas)
        served = phase_serving(tally, dev)
        ragged = phase_ragged(tally, dev)
        soaked = phase_soak(tally, dev)
        phase_baselines_small(tally, dev)
        base, base_launches, library = phase_baselines_main(tally, dev,
                                                            ptxas)
        phase_sweep(dev)
        diff = phase_differentiable(tally, dev)
        dist = phase_distributed(tally, dev)
        benches = phase_benches(dev)
        phase_lm(dev)
        phase_lm_serve(dev)
        multi = phase_multiprocess(dist)
        phase_lm_sharded(dev)
    finally:
        shutil.rmtree(plans, ignore_errors=True)
    k = rows[SERVE_OP]
    kernels = [{
        "name": "mwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mwd.cu",
        "replaces": "src/repro/kernels/stencil_mwd.py:69",
        "launches": (served["k1_launches"] + ragged["k1_launches"]
                     + soaked["k1_launches"] + diff["launches"]
                     + dist["launches"] + benches["launches"]["mwd"]
                     + multi["launches"]),
        "max_abs_err": tally.max_abs_err["mwd"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}]
    # ms, plain_ms and bound_ms at 7pt-var per call, as K1's entry;
    # launches over the 512^3 drive of phase 5 and phase 9's benches
    for name, method, line, lib_ms, lib_call in (
            ("sweep", "spatial", 31, library["library_ms"],
             "F.conv3d 3x3x3, 7pt-const 512^3, one step (K2: k2_step_ms)"),
            ("fused", "ghostzone", 33, None, None)):
        b = base[(SERVE_OP, method)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/stencil_{name}.py:{line}",
            "launches": base_launches[name] + benches["launches"][name],
            "max_abs_err": tally.max_abs_err[name],
            "ms": b["kernel_ms"], "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": lib_ms, "library_call": lib_call})
    check(all(kern["launches"] > 0 for kern in kernels),
          "a kernel of the path was never launched")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
