"""Rank bodies for `test_torch_multiprocess.py` (no jax: spawned ranks
import this module, not the test file).

Each body is ``fn(rank, world_size, init_method, *args)`` for
`repro_torch.distributed.process.launch`: it joins a gloo group over the
launch's file store, runs the port on the CPU (K1's plain version) on one
thread, and returns what the parent compares.
"""

import hashlib
import time

import torch

from repro_torch.core import ir
from repro_torch.core import stencils as st
from repro_torch.core.mwd import MWDPlan
from repro_torch.distributed import checkpoint, halo, process, stepper
from repro_torch.kernels import adjoint
from repro_torch.launch import mesh as lmesh

CPU = torch.device("cpu")
TIMEOUT_S = 120.0
NAMES = list(st.SPECS) + ["dist-custom9"]
# mode -> (steps, overlap, compress): a trailing partial super-step in
# "partial" (overlapped, then one synchronous step) and "compress"
MODES = {"sync": (4, False, False), "overlap": (4, True, False),
         "partial": (5, True, False), "compress": (5, True, True)}
PLANS = ("none", "explicit")
LAYOUTS = ("4x2", "2x2")
VJP_OPS = ("7pt-var", "25pt-const")
VJP_GRID = {1: (8, 8, 12), 4: (32, 16, 18)}
VJP_STEPS = 2
CKPT_OP, CKPT_GRID, CKPT_STEPS = "7pt-var", (24, 16, 8), (2, 3)
BYTES_CASES = (("4x2", "7pt-const"), ("2x2", "7pt-var"),
               ("2x2", "25pt-var"), ("3x3", "25pt-const"))


def custom9():
    """`tests/test_distributed.py`'s user-defined 9-tap op."""
    taps = [ir.Tap(0, 0, 0, ir.array(0))]
    taps += [ir.Tap(*o, ir.array(k + 1)) for k, o in enumerate(
        [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
         (0, 0, 1), (0, -1, -1), (0, 1, 1)])]
    return ir.StencilOp("dist-custom9", tuple(taps), coeff_scale=0.08)


def op(name):
    return custom9() if name == "dist-custom9" else st.SPECS[name]


def grid_of(layout: str, radius: int):
    """The grid of a layout: the reference's overlap grids on 4x2, room
    for the overlapped schedule on 2x2 and 3x3."""
    if layout == "4x2":
        return (24, 16, 8) if radius == 1 else (72, 36, 16)
    return (24, 18, 8) if radius == 1 else (54, 54, 12)


def problem(name, grid, seed=7):
    return ir.make_problem(op(name), grid, seed=seed, device="cpu")


def plan_of(name, plan):
    return (MWDPlan(d_w=2 * op(name).radius, n_f=1) if plan == "explicit"
            else None)


def single_mesh(layout):
    """The single-controller mesh of a layout, over the CPU."""
    shape = {"4x2": (4, 2), "2x2": (2, 2), "3x3": (3, 3)}[layout]
    return lmesh.make_mesh(shape, ("data", "model"),
                           [CPU] * (shape[0] * shape[1]))


def process_mesh(layout):
    """The layout over the ranks: 4x2 is `make_process_mesh` of four
    ranks with two devices each; 2x2 puts one shard on each of four ranks
    (both grid axes cross ranks); 3x3 puts the centre on rank 1 and the
    rest on rank 0."""
    if layout == "4x2":
        return lmesh.make_process_mesh([CPU, CPU])
    if layout == "2x2":
        return lmesh.make_mesh((2, 2), ("data", "model"), [
            process.ProcessDevice(p, 0, CPU) for p in range(4)])
    return lmesh.make_mesh((3, 3), ("data", "model"), [
        process.ProcessDevice(1 if k == 4 else 0, k, CPU) for k in range(9)])


def digest(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def join(rank, world_size, init_method):
    torch.set_num_threads(1)
    process.initialize("gloo", rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=TIMEOUT_S)


def one_exchange_bytes(layout, name, compress):
    """Bytes this rank's Carrier sends in one super-step's exchange."""
    spec = op(name)
    mesh = process_mesh(layout)
    grid = grid_of(layout, spec.radius)
    gs = stepper.GridSharding(mesh)
    state, _ = problem(name, grid)
    cur = gs.shard(state[0])
    prev = gs.shard(state[1]) if spec.time_order == 2 else cur
    err = (stepper.init_halo_error_global(spec, mesh, grid, 2)
           if compress else None)
    carrier = halo.Carrier()
    stepper._Exchange(spec, 2 * spec.radius, cur, prev, err, carrier).land()
    return carrier.sent_bytes


def world4(rank, world_size, init_method, ckpt_dir):
    """Every layout x mode x plan x op; the carriers' bytes; a checkpoint
    written at world size 4."""
    join(rank, world_size, init_method)
    try:
        out = {"runs": {}, "digests": {}, "bytes": {}}
        for layout in LAYOUTS:
            mesh = process_mesh(layout)
            for name in NAMES:
                spec = op(name)
                grid = grid_of(layout, spec.radius)
                state, coeffs = problem(name, grid)
                for mode, (steps, ovl, comp) in MODES.items():
                    for plan in PLANS:
                        got = stepper.run_distributed(
                            spec, mesh, state, coeffs, steps, 2,
                            plan=plan_of(name, plan), overlap=ovl,
                            compress=comp)
                        key = f"{layout}|{mode}|{plan}|{name}"
                        out["digests"][key] = digest(got)
                        if rank == 0:
                            out["runs"][key] = [t.numpy() for t in got]
        for layout, name in BYTES_CASES:
            for comp in (False, True):
                out["bytes"][f"{layout}|{name}|{comp}"] = one_exchange_bytes(
                    layout, name, comp)
        spec = op(CKPT_OP)
        state, coeffs = problem(CKPT_OP, CKPT_GRID)
        got = stepper.run_distributed(spec, process_mesh("2x2"), state,
                                      coeffs, CKPT_STEPS[0], 2, plan="auto")
        checkpoint.save(ckpt_dir, CKPT_STEPS[0],
                        {"cur": got[0], "prev": got[1]})
        return out
    finally:
        process.finalize()


def world2(rank, world_size, init_method, ckpt_dir):
    """The process mesh's rows; distributed_vjp; the world-size-4
    checkpoint resumed; NCCL on one card refused."""
    join(rank, world_size, init_method)
    out = {}
    try:
        mesh = lmesh.make_process_mesh([CPU, CPU])
        out["rows"] = [[(e.process_index, e.id) for e in row]
                       for row in mesh.devices]
        for name in VJP_OPS:
            spec = st.SPECS[name]
            grid = VJP_GRID[spec.radius]
            state, coeffs = problem(name, grid, seed=5)
            w = torch.linspace(-1.0, 1.0, grid[0] * grid[1] * grid[2]
                               ).reshape(grid)
            outs, vjp = adjoint.distributed_vjp(spec, mesh, state, coeffs,
                                                VJP_STEPS, t_block=2)
            grads = vjp((w, torch.zeros_like(w)))
            out[f"vjp|{name}"] = [outs[0].numpy()] + [
                None if g is None else g.numpy() for g in grads]
        spec = op(CKPT_OP)
        state, coeffs = problem(CKPT_OP, CKPT_GRID)
        like = {"cur": state[0], "prev": state[1]}
        step, tree = checkpoint.restore(ckpt_dir, like)
        got = stepper.run_distributed(spec, mesh, (tree["cur"], tree["prev"]),
                                      coeffs, CKPT_STEPS[1], 2, plan="auto")
        out["resumed"] = (step, [t.numpy() for t in got])
    finally:
        process.finalize()
    try:
        process.initialize("nccl", rank=rank, world_size=world_size,
                           init_method=init_method + "_nccl", timeout_s=30,
                           device="cuda:0")
        out["nccl"] = "no error"
    except RuntimeError as e:
        out["nccl"] = str(e)
    return out


def card2(rank, world_size, init_method, registry):
    """Two ranks sharing the card (gloo), two shards each, 64^3 7pt-var
    K1 per shard, synchronous and overlapped: rank 0 returns whether each
    run is bitwise equal to `ops.naive` and the ranks' K1 launches."""
    import os

    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil_mwd

    os.environ["REPRO_TORCH_PLAN_REGISTRY"] = registry
    join(rank, world_size, init_method)
    try:
        dev = torch.device("cuda", 0)
        mesh = lmesh.make_process_mesh([dev, dev])
        spec = st.SPECS["7pt-var"]
        state, coeffs = st.make_problem(spec, (64, 64, 64), seed=3,
                                        device=dev)
        out = {"launches": 0}
        for ovl in (False, True):
            before = stencil_mwd.LAUNCHES.count
            got = stepper.run_distributed(spec, mesh, state, coeffs, 6, 2,
                                          plan="auto", overlap=ovl)
            torch.cuda.synchronize()
            out["launches"] += stencil_mwd.LAUNCHES.count - before
            if rank == 0:
                want = ops.naive(spec, state, coeffs, 6)
                out[ovl] = all(torch.equal(a, b) for a, b in zip(got, want))
        return out
    finally:
        process.finalize()


def hang(rank, world_size, init_method):
    """A rank that never returns: `process.launch`'s deadline must end it."""
    time.sleep(3600)
