"""Multi-pod dry-run: count every (arch x shape x mesh) cell, analytically.

The port of `repro.launch.dryrun`, analytic half. The reference lowers and
compiles each cell with XLA for 256 or 512 forced host devices and reads
its cost and memory analysis. The port has no compiler to ask: it runs
each LM cell's step once on ``meta`` tensors (shapes and dtypes, no
storage, no device) under ``torch.utils.flop_counter.FlopCounterMode``
and a counter of every operator's operand and result bytes, and prices
the counts with `launch.roofline.analyze_counts` against the device spec
(``h100-sxm`` unless ``--spec`` names another). The meshes are
`launch.mesh.abstract_mesh`es of 16x16 and 2x16x16 ``meta`` devices, the
port's ``AbstractMesh``; the per-device argument bytes are the
`training.sharding.local_shape` blocks of the cell's state and inputs.
Nothing is allocated and nothing runs on a card. Each record goes to
``src/repro_torch/results/dryrun.json``, which `launch.report` folds into
section 6 of the port's REPRODUCTION.md.

  python -m repro_torch.launch.dryrun --arch all --shape all
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --mesh pod --out "$(mktemp -d)/dryrun.json"

Not ported: XLA's memory analysis, cost analysis and HLO collective
schedule (`repro.launch.roofline.collective_bytes`). A stencil cell's
collective bytes are its interior shard's halo bytes a super-step, what
the multi-process stepper's carrier sends. An LM cell's are what one
device's sharded step issues (`count_collectives`: the same calls of
`training.spmd` that the ranks make, on meta blocks, counted and not
run), by kind, for every LM cell: Mamba2 and MoE layers, Adafactor and
long-context decode (batch 1, the KV sequence over 'data') included.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import signal
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core import stencils as stc
from repro_torch.launch import roofline
from repro_torch.launch.mesh import abstract_mesh, production_layout
from repro_torch.launch.sweep import RESULTS_DIR
from repro_torch.models import lm
from repro_torch.models.params import tree_sds
from repro_torch.optim.optimizers import tree_map
from repro_torch.training import sharding as shd
from repro_torch.training import spmd
from repro_torch.training import steps

MESHES = {"pod": False, "multipod": True}
DEFAULT_OUT = os.path.join(RESULTS_DIR, "dryrun.json")

# The paper's own "architectures": the four corner-case stencils at
# production grid sizes, through the distributed deep-halo stepper.
GIRIH_GRIDS = {
    "grid_1k": (1024, 1024, 1024),
    "grid_2k": (2048, 2048, 2048),
}
GIRIH_ARCHS = tuple(f"girih-{s}" for s in stc.SPECS)

# fleet-median useful-flops ratio the reference prices uncounted cells at;
# every LM cell is counted here, and the report sets the MoE cells' counts
# beside this guess
MODEL_FLOPS_RATIO = 0.45


def mesh_name(multi_pod: bool) -> str:
    """Display/record name of the pod (16x16) or multi-pod (2x16x16) mesh."""
    return "2x16x16" if multi_pod else "16x16"


def production_mesh(multi_pod: bool):
    """The `production_layout` as an `abstract_mesh` of ``meta`` devices
    (no card needed)."""
    return abstract_mesh(*production_layout(multi_pod))


class OperatorBytes(TorchDispatchMode):
    """Sums each operator's operand and result bytes (views and
    allocations excluded): the traffic of the step run eagerly, one
    kernel an operator, nothing fused."""

    FREE = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in self.FREE:
            seen = {}
            for t in (torch.utils._pytree.tree_leaves((args, kwargs))
                      + torch.utils._pytree.tree_leaves(out)):
                if isinstance(t, torch.Tensor):
                    seen[id(t)] = t.numel() * t.element_size()
            self.bytes += sum(seen.values())
        return out


def _meta(sds_tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), sds_tree)


@functools.lru_cache(maxsize=64)
def count_step(cfg, kind: str, batch: int, seq: int, *, chunk: int = 2048,
               accum: int = 1) -> tuple[float, float]:
    """(FLOPs, operator bytes) of one `kind` step at `batch` x `seq`,
    global, at the config's full depth, on meta tensors. Train runs the
    launcher's train step (loss, backward under remat, the optimizer
    update); prefill the prefill step; decode one serve step against a
    `seq`-long cache."""
    inputs = steps.abstract_inputs(cfg, kind, batch, seq)
    with FlopCounterMode(display=False) as flops, OperatorBytes() as nbytes:
        if kind == "train":
            state_sds, _ = steps.train_state_specs(cfg)
            _, train_step = steps.make_train_step(cfg, chunk=chunk,
                                                  accum=accum)
            train_step(_meta(state_sds), _meta(inputs["batch"]))
        else:
            params = _meta(tree_sds(lm.param_specs(cfg)))
            if kind == "prefill":
                steps.make_prefill_step(cfg, chunk=chunk)(
                    params, _meta(inputs["batch"]))
            else:
                steps.make_serve_step(cfg)(params, _meta(inputs["cache"]),
                                           _meta(inputs["tokens"]))
    return float(flops.get_total_flops()), float(nbytes.bytes)


def _meta_blocks(sds_tree, shardings):
    """Meta tensors of the blocks one device holds (`local_shape`)."""
    return tree_map(lambda s, sh: torch.empty(
        shd.local_shape(s.shape, sh.spec, sh.mesh), dtype=s.dtype,
        device="meta"), sds_tree, shardings)


def count_collectives(cfg, kind: str, batch: int, seq: int, mesh, *,
                      chunk: int = 2048, accum: int = 1) -> dict:
    """Per-device operand bytes by kind (`training.spmd.KINDS`) of one
    `kind` step at global `batch` x `seq` on `mesh`, an abstract mesh:
    the sharded step of the mesh's first device (`spmd.layout_of` gives
    a virtual layout there) run on meta blocks, its collectives counted
    and not run. These are the calls every rank of a process mesh of that
    shape issues, and the bytes its `spmd.COUNTER` counts. A decode is
    laid out by `steps.make_decoder` (at batch 1 the cache's KV slots
    over 'data', the one row on every rank)."""
    inputs = steps.abstract_inputs(cfg, kind, batch, seq)
    with spmd.counting() as counter:
        if kind == "train":
            state_sds, sh_fn = steps.train_state_specs(cfg)
            _, train_step = steps.make_train_step(cfg, chunk=chunk,
                                                  accum=accum, mesh=mesh)
            train_step(_meta_blocks(state_sds, sh_fn(mesh)),
                       _meta(inputs["batch"]))
        else:
            specs = lm.param_specs(cfg)
            params = _meta_blocks(tree_sds(specs),
                                  shd.param_shardings(mesh, specs))
            if kind == "prefill":
                steps.make_prefill_step(cfg, chunk=chunk, mesh=mesh)(
                    params, _meta(inputs["batch"]))
            else:
                dec = steps.make_decoder(cfg, batch, seq, mesh=mesh)
                dec.step(params, _meta_blocks(inputs["cache"], dec.shardings),
                         dec.rows(_meta(inputs["tokens"])))
    return dict(counter.bytes)


def probe_lm_cell(cfg, shape_name: str, mesh, *, chunk: int = 2048,
                  accum: int = 1) -> dict:
    """Per-device (flops, bytes, collective bytes) of the cell's step.

    The reference compiles small-L unrolled probes and extrapolates,
    because XLA's cost analysis counts a loop body once. Meta tensors cost
    no memory, so the port counts the whole depth, every layer run, and
    divides by the mesh's device count. The collective bytes are
    `count_collectives`'."""
    n_dev = mesh.devices.size
    s = SHAPES[shape_name]
    f, b = count_step(cfg, s["kind"], s["global_batch"], s["seq_len"],
                      chunk=chunk, accum=accum)
    coll = count_collectives(cfg, s["kind"], s["global_batch"],
                             s["seq_len"], mesh, chunk=chunk, accum=accum)
    return {"flops": f / n_dev, "bytes": b / n_dev,
            "coll": {k: float(coll.get(k, 0)) for k in roofline.COLLECTIVES}}


def count_lm_cell(cfg, shape_name: str, mesh, *, chunk: int = 2048,
                  n_layers: int = 0, accum: int = 1):
    """Returns (probed, model_flops, model_bytes, arg_bytes, notes).

    `probed` is `probe_lm_cell`'s count; `arg_bytes` the per-device
    bytes of the step's arguments (the train state and batch; the params
    and batch; the params, cache and tokens)."""
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sinfo = SHAPES[shape_name]
    spec_tree = lm.param_specs(cfg)
    n_total, n_active = roofline.active_params(cfg, spec_tree)
    mflops = roofline.model_flops(cfg, sinfo, n_total, n_active)
    n_dev = mesh.devices.size
    mbytes = roofline.analytic_hbm_bytes(cfg, sinfo, n_total, n_active,
                                         n_dev, accum=accum)
    inputs, in_shard_fn = steps.input_specs(cfg, shape_name)
    if sinfo["kind"] == "train":
        state, state_sh_fn = steps.train_state_specs(cfg)
        args = (state, inputs)
        arg_sh = (state_sh_fn(mesh), in_shard_fn(mesh))
    else:
        args = (tree_sds(spec_tree), inputs)
        arg_sh = (shd.param_shardings(mesh, spec_tree), in_shard_fn(mesh))
    arg_bytes = shd.local_bytes(args, arg_sh)
    notes = (f"N={n_total/1e9:.2f}B active={n_active/1e9:.2f}B "
             f"accum={accum} counted/{n_dev}dev")
    probed = probe_lm_cell(cfg, shape_name, mesh, chunk=chunk, accum=accum)
    return probed, mflops, mbytes, arg_bytes, notes


def count_girih_cell(arch: str, grid_name: str, mesh, *, t_block: int = 0,
                     hoisted: bool = False, dtype=None):
    """Distributed deep-halo super-step for one stencil at production size.

    Returns (flops_per_device, model_flops, model_bytes, arg_bytes,
    coll_bytes, notes).
    `arch` is girih-<op>, <op> anything `core.ir.resolve_op` accepts. The
    FLOPs are the op's per-update count over each shard's t_block-step
    trapezoid (`models.ghostzone_redundancy` times the shard's updates);
    the bytes the ghost-zone code balance on the local block; the argument
    bytes the local blocks of cur, prev and the coefficient pair
    (`stepper.coeff_sds`, or `extended_coeff_sds` when hoisted); the
    collective bytes what an interior shard sends a super-step
    (`stepper.interior_halo_bytes`: its four halo slabs per exchanged
    solution stream, as the multi-process carrier ships them), under
    ``collective-permute``.
    """
    from repro_torch.core import ir, precision
    from repro_torch.core import models as cmodels
    from repro_torch.distributed import stepper

    spec = ir.resolve_op(arch.removeprefix("girih-"))
    nz, ny, nx = GIRIH_GRIDS[grid_name]
    tb = t_block or (4 if spec.radius == 1 else 2)
    gs = stepper.GridSharding(mesh)
    dt = precision.parse_dtype(dtype)
    word = precision.word_bytes(dt)
    if hoisted:
        arrays, scalars = stepper.extended_coeff_sds(spec, mesh,
                                                     (nz, ny, nx), tb, dt)
    else:
        arrays, scalars = stepper.coeff_sds(spec, (nz, ny, nx), dt)
    grid_spec = (gs.z_axes, gs.y_axis, None)
    block = shd.local_shape((nz, ny, nx), grid_spec, mesh)
    coeff_block = shd.local_shape(arrays.shape, (None,) + grid_spec, mesh)
    arg_bytes = word * (2 * math.prod(block) + math.prod(coeff_block)) \
        + scalars.nbytes
    n_z, n_y = gs.counts()
    n_dev = mesh.devices.size
    lups = float(nz) * ny * nx * tb
    mflops = spec.flops_per_lup * lups
    redo = cmodels.ghostzone_redundancy(spec.radius, tb, ny // n_y,
                                        nz // n_z)
    bc = cmodels.ghostzone_code_balance(spec, tb, ny // n_y, nz // n_z,
                                        word_bytes=word)
    mbytes = bc * lups / n_dev
    ext = stepper.local_extended_shape(spec, mesh, (nz, ny, nx), tb)
    coll = {"collective-permute": float(stepper.interior_halo_bytes(
        spec, mesh, (nz, ny, nx), tb, word_bytes=word))}
    return (mflops / n_dev * redo, mflops, mbytes, arg_bytes, coll,
            f"t_block={tb} hoisted={hoisted} "
            f"dtype={precision.dtype_name(dt)} Bc_gz={bc:.2f}B/LUP "
            f"local extended block {'x'.join(map(str, ext))}")


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             chunk: int = 2048, n_layers: int = 0, accum: int = 1,
             verbose: bool = True, t_block: int = 0, hoisted: bool = False,
             variant: dict | None = None, tag: str = "", dtype=None):
    """Count one dry-run cell and price its roofline record.

    LM cells count their step at full depth (`probe_lm_cell`), MoE
    routing included (its counts are a scatter-add, which runs on meta
    tensors). Girih (stencil) cells are analytic (`count_girih_cell`).
    Returns a `roofline.DryrunResult`.
    """
    mesh = production_mesh(multi_pod)
    n_dev = mesh.devices.size
    t0 = time.perf_counter()
    coll = None
    if arch.startswith("girih-"):
        flops, mflops, mbytes, arg_bytes, coll, notes = count_girih_cell(
            arch, shape_name, mesh, t_block=t_block, hoisted=hoisted,
            dtype=dtype)
        counted_bytes = None
    else:
        cfg = configs.get(arch)
        if variant:
            cfg = dataclasses.replace(cfg, **variant)
        probed, mflops, mbytes, arg_bytes, notes = count_lm_cell(
            cfg, shape_name, mesh, chunk=chunk, n_layers=n_layers,
            accum=accum)
        flops, counted_bytes = probed["flops"], probed["bytes"]
        coll = probed["coll"]
    res = roofline.analyze_counts(
        arch=arch, shape=shape_name, mesh_name=mesh_name(multi_pod),
        n_devices=n_dev, flops_per_device=flops,
        bytes_per_device=counted_bytes, arg_bytes_per_device=arg_bytes,
        model_flops=mflops, model_bytes=mbytes, coll_bytes=coll,
        lower_s=time.perf_counter() - t0,
        notes=(f"[{tag}] " if tag else "") + notes)
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name(multi_pod)}] "
              f"counted in {res.lower_s:.1f}s: "
              f"args/dev={res.arg_bytes_per_device/2**30:.2f}GiB "
              f"flops/dev={res.flops_per_device:.3e} "
              f"model_bytes/dev={res.model_bytes_per_device:.3e} "
              f"-> {res.terms.dominant} ({notes})")
    return res


def iter_cells(arch_sel: str, shape_sel: str):
    """Yield (arch, shape, skip_reason) cells matching the CLI selectors."""
    archs = list(configs.ARCH_IDS) + list(GIRIH_ARCHS) \
        if arch_sel == "all" else [arch_sel]
    for arch in archs:
        if arch.startswith("girih-"):
            shapes = list(GIRIH_GRIDS) if shape_sel == "all" else [shape_sel]
            for s in shapes:
                if s in GIRIH_GRIDS:
                    yield arch, s, ""
        else:
            cfg = configs.get(arch)
            shapes = list(SHAPES) if shape_sel == "all" else [shape_sel]
            for s in shapes:
                if s not in SHAPES:
                    continue
                ok, why = shape_applicable(cfg, s)
                yield arch, s, ("" if ok else why)


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags (no ``XLA_FLAGS``: nothing is compiled)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, girih-<stencil> (paper, registered custom "
                         "op, or girih-module.path:ATTR), or 'all'")
    ap.add_argument("--op-module", default=None,
                    help="import this module first (it registers custom "
                         "StencilOps via repro_torch.core.ir.register)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod",
                                                       "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="override layer count")
    ap.add_argument("--accum", type=int, default=0,
                    help="gradient-accumulation microbatches (train cells); "
                         "0 = auto (8 for the >=7168-wide giants)")
    ap.add_argument("--cell-timeout", type=int, default=1800,
                    help="seconds per cell before recording a timeout")
    ap.add_argument("--tag", default="", help="variant label in notes")
    ap.add_argument("--t-block", type=int, default=0, help="girih t_block")
    ap.add_argument("--hoisted", action="store_true",
                    help="girih: hoisted (pre-extended) coefficients")
    ap.add_argument("--dtype", default=None,
                    help="girih: stream dtype (f32/bf16/fp16); the modeled "
                         "bytes column scales with the word")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="LM: sequence-parallel attention")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--grad-dtype", default="")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--spec", default=None,
                    help="device spec name or spec-file path the roofline "
                         "terms price against (default: "
                         "$REPRO_TORCH_DEVICE_SPEC or h100-sxm)")
    return ap


def main(argv=None):
    """CLI entry point: run the selected cells, appending to --out."""
    args = build_parser().parse_args(argv)
    if args.spec:
        from repro_torch.core import specs as devspecs
        devspecs.set_default_spec(args.spec)
    if args.op_module:
        import importlib
        importlib.import_module(args.op_module)
    cells = list(iter_cells(args.arch, args.shape))
    if args.list:
        for arch, s, skip in cells:
            print(f"{arch:24s} {s:12s} {'SKIP: ' + skip if skip else 'run'}")
        return

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    results, failures = [], []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))
            for r in results if "skip" not in r}
    for arch, shape_name, skip in cells:
        for m in meshes:
            key = (arch, shape_name, mesh_name(MESHES[m]), args.tag)
            if key in done:
                print(f"[cached] {key}")
                continue
            if skip:
                print(f"[skip] {arch} x {shape_name}: {skip}")
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh_name(MESHES[m]), "skip": skip})
                continue
            try:
                accum = args.accum
                if accum == 0 and not arch.startswith("girih-"):
                    # auto: giant models need microbatching to fit HBM
                    accum = 8 if configs.get(arch).d_model >= 7168 \
                        and shape_name == "train_4k" else 1
                if args.cell_timeout:
                    def _alarm(signum, frame):
                        raise TimeoutError(
                            f"cell exceeded {args.cell_timeout}s")
                    signal.signal(signal.SIGALRM, _alarm)
                    signal.alarm(args.cell_timeout)
                variant = {}
                if args.seq_parallel:
                    variant["seq_parallel_attn"] = True
                if args.capacity_factor:
                    variant["capacity_factor"] = args.capacity_factor
                if args.grad_dtype:
                    variant["grad_dtype"] = args.grad_dtype
                res = run_cell(arch, shape_name, MESHES[m],
                               chunk=args.chunk, n_layers=args.n_layers,
                               accum=max(accum, 1), t_block=args.t_block,
                               hoisted=args.hoisted, variant=variant,
                               tag=args.tag, dtype=args.dtype)
                signal.alarm(0)
                results.append(dict(res.to_json(), tag=args.tag))
            except Exception as e:
                signal.alarm(0)
                traceback.print_exc()
                failures.append((key, str(e)))
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh_name(MESHES[m]),
                                "error": str(e)[:500]})
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells recorded, {len(failures)} failures")
    for k, e in failures:
        print(f"  FAIL {k}: {e[:200]}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
