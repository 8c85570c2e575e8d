"""Rank bodies for `test_torch_lm_sharded.py` (no jax: spawned ranks
import this module, not the test file).

Each body is ``fn(rank, world_size, init_method, *args)`` for
`repro_torch.distributed.process.launch`: it joins a gloo group over the
launch's file store, runs the port's sharded LM step on the CPU on one
thread, and returns what the parent compares. Weights, optimizer states,
caches and batches come from the parent as numpy trees (the reference's,
carried across with `from_reference`).
"""

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import configs as tc
from repro_torch.distributed import checkpoint, process
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.models import params as tparams
from repro_torch.optim.optimizers import tree_paths
from repro_torch.training import sharding as shd
from repro_torch.training import spmd
from repro_torch.training import steps as tsteps

CPU = torch.device("cpu")
TIMEOUT_S = 120.0
DENSE = ("llama3.2-1b", "gemma3-1b", "qwen3-4b", "h2o-danube-3-4b",
         "hubert-xlarge", "qwen2-vl-2b")
DECODERS = tuple(a for a in DENSE if a != "hubert-xlarge")
MESHES = ((2, 2), (1, 4), (4, 1))
SERVE_MESHES = ((1, 4), (2, 2))
ACCUMS = (1, 2)
BATCH, SEQ, CHUNK = 8, 16, 8      # accum 2 divides each rank's rows on (4, 1)
SERVE = {"batch": 4, "prompt_len": 6, "gen": 4}
CACHE_BATCH, CACHE_LEN = 4, 12
BYTES_MESHES = ((2, 2), (1, 4))   # one reduced llama step, against the dry-run
CKPT_ARCH, CKPT_FROM, CKPT_TO = "llama3.2-1b", (2, 2), (1, 4)
REFUSED = ("mamba2-130m", "mixtral-8x7b")


def f32(arch):
    """The reduced config of `arch` in float32."""
    return dataclasses.replace(tc.reduced(tc.get(arch)), dtype="float32")


def lm_batch(cfg, b=BATCH, s=SEQ, seed=0) -> dict:
    """A numpy batch: tokens or frontend embeddings, distinct M-RoPE rows
    per sample, labels."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        out["positions"] = (np.arange(s, dtype=np.int32)[None, None]
                            + np.arange(b, dtype=np.int32)[None, :, None]
                            + np.zeros((3, 1, 1), np.int32))
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def random_cache(cfg, seed=3) -> dict:
    """A numpy decode cache of `cfg` with random entries (lengths 5)."""
    rng = np.random.default_rng(seed)
    spec = lm.cache_spec(cfg, CACHE_BATCH, CACHE_LEN)

    def one(s):
        if s.dtype == torch.int32:
            return np.full(s.shape, 5, np.int32)
        return rng.standard_normal(s.shape).astype(np.float32)

    from repro_torch.optim.optimizers import tree_map
    return tree_map(one, spec)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def blocks(tree) -> dict:
    """``{leaf name: (block shape, sha1 of its bytes)}``."""
    return {n: (tuple(t.shape), digest(t)) for n, t in tree_paths(tree)}


def join(rank, world_size, init_method):
    torch.set_num_threads(1)
    process.initialize("gloo", rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=TIMEOUT_S)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


def train(cfg, mesh, weights, batch, accum) -> dict:
    """Two train steps from `weights` on `batch` (a sharded step on a
    process `mesh`, else the one-process step): step 0's metrics, the
    loss one update later, the parameters after step 0 gathered whole,
    the bytes counted in step 0, and the state's resident bytes beside
    `local_bytes`."""
    opt, step = tsteps.make_train_step(cfg, chunk=CHUNK, accum=accum,
                                       mesh=mesh)
    specs = lm.param_specs(cfg)
    params = tparams.from_reference(weights, CPU)
    if mesh is not None:
        params = shd.place(params, shd.param_shardings(mesh, specs))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    spmd.COUNTER.reset()
    state, m0 = step(state, b)
    counted = spmd.COUNTER.snapshot()["bytes"]
    new = state["params"]
    if mesh is not None:
        new = shd.gather(new, shd.param_shardings(mesh, specs))
        sds, sh_fn = tsteps.train_state_specs(cfg)
        local = shd.local_bytes(sds, sh_fn(mesh))
    else:
        local = nbytes(state)
    resident = nbytes(state)
    state, m1 = step(state, b)
    return {"m0": {k: float(v) for k, v in m0.items()},
            "loss1": float(m1["loss"]),
            "params": {n: t.numpy() for n, t in tree_paths(new)},
            "counted": counted, "resident": resident, "local": local}


def world4(rank, world_size, init_method, weights, opt_states, caches,
           ckpt_dir):
    """Every dense config on (2, 2), (1, 4) and (4, 1): each rank's
    placed blocks of a reference train state and of a random cache; two
    train steps at accum 1 and 2; `serve_lm` of the decoders on (1, 4)
    and (2, 2); a checkpoint written on (2, 2) and restored on (1, 4)."""
    join(rank, world_size, init_method)
    try:
        out = {"layout": {}, "train": {}, "serve": {}}
        meshes = {s: lmesh.rank_mesh(s, device=CPU) for s in MESHES}
        for arch in DENSE:
            cfg = f32(arch)
            full = {"params": tparams.from_reference(weights[arch], CPU),
                    "opt": tparams.from_reference(opt_states[arch], CPU),
                    "step": torch.zeros((), dtype=torch.int32)}
            cache = tparams.from_reference(caches[arch], CPU)
            spec = lm.cache_spec(cfg, CACHE_BATCH, CACHE_LEN)
            batch = lm_batch(cfg)
            for shape, mesh in meshes.items():
                placed = shd.place(full, tsteps.train_state_specs(cfg)[1](
                    mesh))
                c_placed = shd.place(cache, shd.cache_shardings(
                    mesh, cfg, spec, seq_shard=False))
                out["layout"][arch, shape] = {
                    "state": blocks(placed), "cache": blocks(c_placed),
                    "position": shd.mesh_position(mesh)}
                for accum in ACCUMS:
                    got = train(cfg, mesh, weights[arch], batch, accum)
                    if rank:
                        got.pop("params")
                    out["train"][arch, shape, accum] = got
            if cfg.supports_decode:
                for shape in SERVE_MESHES:
                    rec = tserve.serve_lm(cfg, **SERVE, device=CPU,
                                          mesh=meshes[shape])
                    c_spec = lm.cache_spec(
                        cfg, SERVE["batch"],
                        SERVE["prompt_len"] + SERVE["gen"])
                    c_sh = shd.cache_shardings(meshes[shape], cfg, c_spec,
                                               seq_shard=False)
                    out["serve"][arch, shape] = {
                        "ids": rec["ids"].numpy(),
                        "cache": {n: tuple(t.shape) for n, t in
                                  tree_paths(rec["cache"])},
                        "want": {n: shd.local_shape(s.shape, h.spec, h.mesh)
                                 for (n, s), (_, h) in zip(
                                     tree_paths(c_spec), tree_paths(c_sh))},
                        "gathered": {n: t.numpy() for n, t in tree_paths(
                            shd.gather(rec["cache"], c_sh))}}
        # a checkpoint written on (2, 2), restored on (1, 4)
        cfg = f32(CKPT_ARCH)
        opt, step = tsteps.make_train_step(cfg, chunk=CHUNK,
                                           mesh=meshes[CKPT_FROM])
        sh_from = tsteps.train_state_specs(cfg)[1](meshes[CKPT_FROM])
        params = shd.place(tparams.from_reference(weights[CKPT_ARCH], CPU),
                           sh_from["params"])
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32)}
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                lm_batch(cfg).items()})
        checkpoint.save(ckpt_dir, 1, state, shardings=sh_from)
        written = shd.gather(state, sh_from)
        sh_to = tsteps.train_state_specs(cfg)[1](meshes[CKPT_TO])
        like = {"params": tparams.tree_abstract(lm.param_specs(cfg)),
                "step": torch.zeros((), dtype=torch.int32)}
        like["opt"] = opt.init(like["params"])
        _, restored = checkpoint.restore(ckpt_dir, like, shardings=sh_to)
        out["ckpt"] = {"written": blocks(written),
                       "restored": blocks(shd.gather(restored, sh_to)),
                       "restored_blocks": {
                           n: tuple(t.shape)
                           for n, t in tree_paths(restored)},
                       "want_blocks": {
                           n: shd.local_shape(t.shape, h.spec, h.mesh)
                           for (n, t), (_, h) in zip(tree_paths(written),
                                                     tree_paths(sh_to))}}
        return out
    finally:
        process.finalize()


def world2(rank, world_size, init_method, weights):
    """The refusals of Mamba2 and MoE on a (1, 2) mesh; a (1, 1) mesh of
    each rank's own device (no collective) beside the one-process step,
    for every dense config and for the refused ones."""
    join(rank, world_size, init_method)
    try:
        out = {"refused": {}, "one": {}}
        pair = lmesh.rank_mesh((1, 2), device=CPU)
        own = lmesh.make_mesh((1, 1), ("data", "model"), [
            process.ProcessDevice(rank, 0, CPU)])
        for arch in REFUSED:
            cfg = f32(arch)
            for what, make in (
                    ("train", lambda: tsteps.make_train_step(cfg,
                                                             mesh=pair)),
                    ("serve", lambda: tsteps.make_serve_step(cfg,
                                                             mesh=pair))):
                try:
                    make()
                    out["refused"][arch, what] = None
                except NotImplementedError as e:
                    out["refused"][arch, what] = str(e)
        for arch in DENSE + REFUSED:
            cfg = f32(arch)
            batch = lm_batch(cfg)
            got = train(cfg, own, weights[arch], batch, 1)
            want = train(cfg, None, weights[arch], batch, 1)
            out["one"][arch] = {
                "metrics": (got["m0"], got["loss1"]) == (want["m0"],
                                                         want["loss1"]),
                "params": all(np.array_equal(got["params"][n], a)
                              for n, a in want["params"].items()),
                "counted": got["counted"], "loss": got["m0"]["loss"]}
        return out
    finally:
        process.finalize()


def card2(rank, world_size, init_method):
    """Two gloo ranks sharing the card: the reduced llama step on a
    (1, 2) mesh in float32 beside the one-process step on the card (rank
    0): step 0's metrics, the next loss, and the parameters' largest
    difference relative to their norm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    process.initialize("gloo", rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=TIMEOUT_S)
    try:
        cfg = f32("llama3.2-1b")
        mesh = lmesh.rank_mesh((1, 2), device=dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in lm_batch(cfg).items()}
        specs = lm.param_specs(cfg)
        runs = {}
        for name, m in (("sharded", mesh), ("one", None)):
            opt, step = tsteps.make_train_step(cfg, chunk=CHUNK, mesh=m)
            params = tparams.tree_init(specs, seed=1, device=dev)
            if m is not None:
                params = shd.place(params, shd.param_shardings(m, specs))
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32)}
            state, m0 = step(state, batch)
            new = (shd.gather(state["params"], shd.param_shardings(m, specs))
                   if m is not None else state["params"])
            state, m1 = step(state, batch)
            runs[name] = ({k: float(v) for k, v in m0.items()},
                          float(m1["loss"]),
                          {n: t.cpu() for n, t in tree_paths(new)})
        (a, la, pa), (b, lb, pb) = runs["sharded"], runs["one"]
        return {"metrics": (a, b), "loss1": (la, lb),
                "params_rel": max(float((pa[n] - pb[n]).norm()
                                        / pb[n].norm().clamp_min(1e-30))
                                  for n in pb)}
    finally:
        process.finalize()
