#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build, check, run, serve.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card (an
H100: the kernels build for sm_90a). Phases, each of which raises on
failure so the script exits non-zero:

1. setup: the card's name and power limit (nvidia-smi), then every CUDA
   source under src/repro_torch/kernels/csrc/ built with nvcc;
2. K1 (the MWD kernel) against its plain PyTorch version on the card at a
   mid-size grid: the four paper ops and the custom mixed op aniso11, fused
   and per-row, a B=2 batch against a per-item loop, a grid that is not a
   multiple of D_w or N_F, n_steps=0, f32 (bitwise), bf16/fp16 with f32
   accumulation and bf16 with native accumulation;
3. the main path at the production grid: ops.mwd(plan="auto") at 512^3 for
   the four paper ops, 8 steps, against ops.naive on the card, K1 against
   its plain version on the same inputs, and K1's time by CUDA events
   beside its bound;
4. serving: serve_stencil("7pt-var", 512^3, 8 steps, 4 requests,
   max_batch=2), every response bitwise equal to its own sequential
   ops.mwd, with K1's launch count read around the serving run, and K1
   against its plain version at the serving batch's shape (B=2, 512^3);
5. the baselines: K2 (the spatial sweep) and K3 (the ghost-zone pass)
   against their plain versions at the mid-size grid and at a grid that is
   not a multiple of bz/by, for the four paper ops and aniso11 (f32
   bitwise, native bf16 within op.tolerance, n_steps=0, a t_block that does
   not divide n_steps); then ops.spatial and ops.ghostzone at 512^3 x 8
   steps with default parameters against ops.naive, K2 and K3 against
   their plain versions on the same inputs, their times by CUDA events
   beside their bounds, and F.conv3d as K2's library yardstick (7pt-const).

Before the last line come one `baseline` JSON line per (op, method) and a
JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MID_GRID = (48, 64, 40)
ODD_GRID = (37, 53, 29)
MAIN_GRID = (512, 512, 512)
MAIN_STEPS = 8
SERVE_OP = "7pt-var"
TIMING_REPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 non-tensor FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


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


def bound(op, grid, n_steps, *, passes=1, outputs=2, batch=1, word=4):
    """Least time (ms) for the work: compulsory bytes vs f32 flops.

    Each of `passes` launches reads every input stream once and writes
    `outputs` grids: K1 is one pass writing both levels, K2 one pass per
    step writing one grid, K3 one pass per t_block steps writing two.
    """
    cells = batch * grid[0] * grid[1] * grid[2]
    inputs = 1 + (op.time_order == 2) + op.n_coeff_arrays
    t_bytes = passes * (inputs + outputs) * cells * word / HBM_BPS
    t_ops = op.flops_per_lup * cells * n_steps / F32_FLOPS
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
                           f"(max err {err:.3g})")
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
        kernel's cropped result and whether it was bitwise.
        """
        import torch
        from repro_torch.kernels import stencil_mwd as sm
        jk = sm.prepare(spec, state, arrays, scalars, n_steps, **kw)
        jp = sm.prepare(spec, state, arrays, scalars, n_steps, **kw)
        sm.run_kernel(jk)
        torch.cuda.synchronize()
        sm.run_plain(jp)
        torch.cuda.synchronize()
        bitwise = self.record("mwd", jk.bufs, jp.bufs, f"{spec.name} {kw}",
                              tol)
        return sm.finish(jk), bitwise


def phase_setup():
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log("card (nvidia-smi name, power.limit):")
    log(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, b in built.items():
        log(f"built {name}: {b.path.name} nvcc {b.seconds:.1f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"phase 1 setup: {time.perf_counter() - t0:.1f} s")


def phase_kernel_checks(tally: Tally, dev) -> None:
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    specs = list(st.SPECS.values()) + [aniso11(ir)]
    for spec in specs:
        d_w = 12 if spec.radius == 3 else 8
        state, coeffs = st.make_problem(spec, MID_GRID, seed=1, device=dev)
        arrays, scalars = ir.split_coeffs(spec, coeffs)
        kw = dict(d_w=d_w, n_f=2)
        fused, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 8,
                                         fused=True, **kw)
        row, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 8,
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
            _, bitwise = tally.kernel_vs_plain(
                spec, rs, ra, rsc, 8, fused=True, acc_dtype=acc,
                tol=spec.tolerance(dt), **kw)
            log(f"  {spec.name} {dt} acc={acc}: kernel vs plain "
                f"{'bitwise' if bitwise else 'within op.tolerance'}")
        log(f"  {spec.name}: f32 fused/per-row/batched/n_steps=0 bitwise "
            f"vs plain version; kernel vs naive err {err:.3g}")
    spec = st.SPECS["7pt-const"]
    state, coeffs = st.make_problem(spec, ODD_GRID, seed=4, device=dev)
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    out, _ = tally.kernel_vs_plain(spec, state, arrays, scalars, 5, d_w=8,
                                   n_f=4, fused=True)
    naive = ops.naive(spec, state, coeffs, 5)
    check(all(same(a, b) for a, b in zip(out, naive)),
          "non-multiple grid: kernel != naive")
    log(f"  non-multiple grid {ODD_GRID}: bitwise vs plain and naive")
    log(f"phase 2 kernel checks: {time.perf_counter() - t0:.1f} s, "
        f"max |kernel - plain| {tally.max_abs_err['mwd']:.3g}")


def phase_main_path(tally: Tally, dev) -> dict:
    import torch
    from repro_torch.core import ir
    from repro_torch.core import stencils as st
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd as sm
    t0 = time.perf_counter()
    rows = {}
    for name, spec in st.SPECS.items():
        t_gen = time.perf_counter()
        state, coeffs = st.make_problem(spec, MAIN_GRID, seed=0, device=dev)
        t_gen = time.perf_counter() - t_gen
        plan = ops.resolve_plan(spec, state, "auto")
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
        mwd_ms = cuda_ms(lambda: ops.mwd(spec, state, coeffs, MAIN_STEPS,
                                         plan="auto"), 2)
        naive_ms = cuda_ms(lambda: ops.naive(spec, state, coeffs,
                                             MAIN_STEPS), 1)
        del job, saved
        b_ms, b_by = bound(spec, MAIN_GRID, MAIN_STEPS)
        lups = MAIN_GRID[0] * MAIN_GRID[1] * MAIN_GRID[2] * MAIN_STEPS
        row = {"op": name, "grid": list(MAIN_GRID), "steps": MAIN_STEPS,
               "plan": f"dw{plan.d_w}.nf{plan.n_f}."
                       f"{'fused' if plan.fused else 'row'}",
               "kernel_ms": kernel_ms, "glups": lups / kernel_ms / 1e6,
               "launches_per_call": launches, "bound_ms": b_ms,
               "bound_by": b_by, "roofline_share": b_ms / kernel_ms,
               "plain_ms": plain_ms, "ops_mwd_ms": mwd_ms,
               "naive_ms": naive_ms, "err_vs_naive": err,
               "bitwise_vs_naive": bitwise_naive, "gen_s": t_gen}
        rows[name] = row
        log("main " + json.dumps(row))
        del state, coeffs, arrays
        torch.cuda.empty_cache()
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
               "served": rep["served"], "batch_sizes": rep["batch_sizes"],
               "p50_ms": float(rep["p50_ms"]), "p99_ms": float(rep["p99_ms"]),
               "glups": rep["glups"], "wall_s": rep["wall_s"],
               "k1_launches": launches}
    log("serving " + json.dumps(summary))
    log(f"phase 4 serving: {time.perf_counter() - t0:.1f} s")
    return summary


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
    # (grid, dtype, ops.spatial kwargs, ops.ghostzone kwargs, n_steps)
    cases = [(MID_GRID, "f32", dict(bz=8), dict(t_block=3, bz=8, by=8), 5),
             (MID_GRID, "f32", {}, {}, MAIN_STEPS),
             (ODD_GRID, "f32", dict(bz=8), dict(t_block=3, bz=8, by=8), 5),
             (MID_GRID, "bf16", dict(bz=8), dict(t_block=3, bz=8, by=8), 5)]
    for spec in list(st.SPECS.values()) + [aniso11(ir)]:
        for grid, dt, kw_s, kw_g, n in cases:
            state, coeffs = st.make_problem(spec, grid, dtype=dt, seed=5,
                                            device=dev)
            arrays, scalars = ir.split_coeffs(spec, coeffs)
            tol = None if dt == "f32" else spec.tolerance(dt)
            what = f"{spec.name} {grid} {dt} n_steps={n}"
            got_s = ops.spatial(spec, state, coeffs, n, **kw_s)
            want = plain_spatial(spec, state, arrays, scalars, n)
            torch.cuda.synchronize()
            bit_s = tally.record("sweep", got_s, want, f"{what} {kw_s}", tol)
            got_g = ops.ghostzone(spec, state, coeffs, n, **kw_g)
            want = plain_ghostzone(spec, state, arrays, scalars, n,
                                   **{**GHOSTZONE_DEFAULTS, **kw_g})
            torch.cuda.synchronize()
            bit_g = tally.record("fused", got_g, want, f"{what} {kw_g}", tol)
            if dt == "f32":
                naive = ops.naive(spec, state, coeffs, n)
                check(all(same(a, b) for a, b in zip(got_s, naive))
                      and all(same(a, b) for a, b in zip(got_g, naive)),
                      f"{what}: spatial/ghostzone != naive")
            log(f"  {what}: K2 {kw_s} and K3 {kw_g} "
                f"{'bitwise' if bit_s and bit_g else 'within op.tolerance'}"
                f" vs plain")
        # n_steps = 0: the identity, no launch
        before = (sw.LAUNCHES.count, fu.LAUNCHES.count)
        for fn in (ops.spatial, ops.ghostzone):
            zero = fn(spec, state, coeffs, 0)
            check(all(same(a, b) for a, b in zip(zero, state)),
                  f"{spec.name}: {fn.__name__} n_steps=0 is not the identity")
        check((sw.LAUNCHES.count, fu.LAUNCHES.count) == before,
              f"{spec.name}: n_steps=0 launched a kernel")
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
    lib_out = F.conv3d(x, w)                               # warm-up
    library_ms = cuda_ms(lambda: F.conv3d(x, w), TIMING_REPS)
    k2 = sw.run_kernel(spec, state, None, scalars)         # warm-up
    step_ms = cuda_ms(lambda: sw.run_kernel(spec, state, None, scalars),
                      TIMING_REPS)
    err = max_err(lib_out[0, 0], k2[0][1:-1, 1:-1, 1:-1])
    return {"library_ms": library_ms, "k2_step_ms": step_ms,
            "library_err_vs_k2": err}


def phase_baselines_main(tally: Tally, dev) -> tuple[dict, dict, dict]:
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
        state, coeffs = st.make_problem(spec, MAIN_GRID, seed=0, device=dev)
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
            rows[(name, method)] = row
            log("baseline " + json.dumps(row))
        del state, coeffs, arrays, naive
        torch.cuda.empty_cache()
    log(f"phase 5b baselines at {MAIN_GRID}: "
        f"{time.perf_counter() - t0:.1f} s")
    return rows, launches, library


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    phase_setup()
    tally = Tally()
    phase_kernel_checks(tally, dev)
    rows = phase_main_path(tally, dev)
    served = phase_serving(tally, dev)
    phase_baselines_small(tally, dev)
    base, base_launches, library = phase_baselines_main(tally, dev)
    k = rows[SERVE_OP]
    kernels = [{
        "name": "mwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mwd.cu",
        "replaces": "src/repro/kernels/stencil_mwd.py:69",
        "launches": served["k1_launches"],
        "max_abs_err": tally.max_abs_err["mwd"],
        "ms": k["kernel_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None}]
    # ms, plain_ms and bound_ms at 7pt-var per call, as K1's entry;
    # launches over the 512^3 drive of phase 5
    for name, method, line, lib_ms, lib_call in (
            ("sweep", "spatial", 31, library["library_ms"],
             "F.conv3d 3x3x3, 7pt-const 512^3, one step (K2: k2_step_ms)"),
            ("fused", "ghostzone", 33, None, None)):
        b = base[(SERVE_OP, method)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/stencil_{name}.py:{line}",
            "launches": base_launches[name],
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
