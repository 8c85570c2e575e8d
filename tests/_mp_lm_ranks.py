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
# Mamba2, mixture-of-experts and Adafactor (test_torch_lm_sharded_moe_ssm.py)
MOE_SSM = ("mamba2-130m", "mixtral-8x7b", "kimi-k2-1t-a32b",
           "jamba-1.5-large-398b")
DROP_ARCH, DROP_FACTOR, DROP_MESHES = "mixtral-8x7b", 0.5, ((2, 2), (4, 1))
AXES3 = ("pod", "data", "model")
MESHES3, THREE = ((2, 1, 2), (2, 2, 1)), ("llama3.2-1b", "mixtral-8x7b")
# long-context decode: batch 1, the KV slots over 'data'; the next write
# (slot 40, ring slot 8) lands on a non-zero data rank
LONG = ("gemma3-1b", "h2o-danube-3-4b", "llama3.2-1b", "mamba2-130m",
        "jamba-1.5-large-398b")
LONG_MESHES, LONG_CAP, LONG_LEN, LONG_GEN = ((4, 1), (2, 2)), 64, 40, 4
INIT_ARCH, INIT_MESH = "jamba-1.5-large-398b", (2, 2)
# two Mamba2 heads of 64 on a 4-way 'model' axis: the columns split, the
# heads do not (mamba2-130m's 24 heads on the production mesh's 16)
UNEVEN = ("mamba2-130m", {"ssm_head_dim": 64}, (1, 4))


def f32(arch, **changes):
    """The reduced config of `arch` in float32 (with `changes`)."""
    return dataclasses.replace(tc.reduced(tc.get(arch)), dtype="float32",
                               **changes)


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


def random_cache(cfg, seed=3, batch=CACHE_BATCH, cap=CACHE_LEN,
                 length=5) -> dict:
    """A numpy decode cache of `cfg` with random entries."""
    rng = np.random.default_rng(seed)
    spec = lm.cache_spec(cfg, batch, cap)

    def one(s):
        if s.dtype == torch.int32:
            return np.full(s.shape, length, np.int32)
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


# what `train` returns whole: the parameters after each update, the
# optimizer state after the second
WHOLE = ("params", "params2", "opt2")


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))


def train(cfg, mesh, weights, batch, accum) -> dict:
    """Two train steps from `weights` on `batch` (a sharded step on a
    process `mesh`, else the one-process step): step 0's metrics, the
    loss one update later, the parameters after each update and the
    optimizer state after the second (the update that reads back the
    first's moments: Adafactor's decay is 0 at step 0) gathered whole,
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
    new2 = {"params2": state["params"], "opt2": state["opt"]}
    if mesh is not None:
        sh = tsteps.train_state_specs(cfg)[1](mesh)
        new2 = shd.gather(new2, {"params2": sh["params"],
                                 "opt2": sh["opt"]})
    return {"m0": {k: float(v) for k, v in m0.items()},
            "loss1": float(m1["loss"]),
            "params": {n: t.numpy() for n, t in tree_paths(new)},
            **{part: {n: t.numpy() for n, t in tree_paths(tree)}
               for part, tree in new2.items()},
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
                        for part in WHOLE:
                            got.pop(part)
                    out["train"][arch, shape, accum] = got
            if cfg.supports_decode:
                for shape in SERVE_MESHES:
                    rec = tserve.serve_lm(cfg, **SERVE, device=CPU,
                                          mesh=meshes[shape])
                    cache_len = SERVE["prompt_len"] + SERVE["gen"]
                    c_spec = lm.cache_spec(cfg, SERVE["batch"], cache_len)
                    c_sh = tsteps.make_decoder(
                        cfg, SERVE["batch"], cache_len,
                        mesh=meshes[shape]).shardings
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
    """A (1, 1) mesh of each rank's own device (no collective) beside the
    one-process step, for all ten configs."""
    join(rank, world_size, init_method)
    try:
        out = {"one": {}}
        own = lmesh.make_mesh((1, 1), ("data", "model"), [
            process.ProcessDevice(rank, 0, CPU)])
        for arch in DENSE + MOE_SSM:
            cfg = f32(arch)
            batch = lm_batch(cfg)
            got = train(cfg, own, weights[arch], batch, 1)
            want = train(cfg, None, weights[arch], batch, 1)
            out["one"][arch] = {
                "metrics": (got["m0"], got["loss1"]) == (want["m0"],
                                                         want["loss1"]),
                "params": all(np.array_equal(got[part][n], a)
                              for part in WHOLE
                              for n, a in want[part].items()),
                "counted": got["counted"], "loss": got["m0"]["loss"]}
        return out
    finally:
        process.finalize()


def card_join(rank, world_size, init_method):
    """Join a gloo group on cuda:0, float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    process.initialize("gloo", rank=rank, world_size=world_size,
                       init_method=init_method, timeout_s=TIMEOUT_S)
    return dev


def card_steps(arch, dev) -> dict:
    """The reduced float32 step of `arch` on a (1, 2) mesh of the two
    ranks beside the one-process step on the card: step 0's metrics, the
    next loss, and the parameters' largest difference relative to their
    norm."""
    cfg = f32(arch)
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


def card2(rank, world_size, init_method):
    """Two gloo ranks sharing the card: `card_steps` of reduced llama."""
    dev = card_join(rank, world_size, init_method)
    try:
        return card_steps("llama3.2-1b", dev)
    finally:
        process.finalize()


def card2_moe_ssm(rank, world_size, init_method):
    """Two gloo ranks sharing the card: `card_steps` of reduced mixtral
    (experts over 'model') and mamba2 (heads over 'model'), and their
    `serve_lm` ids on the (1, 2) mesh beside one process's."""
    dev = card_join(rank, world_size, init_method)
    try:
        out = {}
        for arch in ("mixtral-8x7b", "mamba2-130m"):
            got = card_steps(arch, dev)
            cfg = f32(arch)
            pair = lmesh.rank_mesh((1, 2), device=dev)
            got["ids"] = (
                tserve.serve_lm(cfg, **SERVE, device="cuda",
                                mesh=pair)["ids"],
                tserve.serve_lm(cfg, **SERVE, device="cuda")["ids"])
            out[arch] = got
        return out
    finally:
        process.finalize()


def long_cache(cfg, seed=5) -> dict:
    """A batch-1 numpy cache of `LONG_CAP` slots at length `LONG_LEN`."""
    return random_cache(cfg, seed, batch=1, cap=LONG_CAP, length=LONG_LEN)


def decode_long(cfg, mesh, cache) -> dict:
    """`LONG_GEN` greedy batch-1 steps of token 7 from `cache` (numpy)
    with seed-0 weights, laid out by `steps.make_decoder`: on a process
    `mesh` the cache's KV slots over 'data', else one process. The ids,
    the logits made whole, and the bytes the first step counted."""
    specs = lm.param_specs(cfg)
    dec = tsteps.make_decoder(cfg, 1, LONG_CAP, mesh=mesh)
    c = dec.place(tparams.from_reference(cache, CPU))
    if mesh is None:
        params = tparams.tree_init(specs, seed=0, device=CPU)
    else:
        params = shd.init_blocks(specs, 0, shd.param_shardings(mesh, specs))
    tok = torch.tensor([[7]], dtype=torch.int32)
    ids, logits, counted = [], [], None
    for _ in range(LONG_GEN):
        spmd.COUNTER.reset()
        tok, lg, c = dec.step(params, c, tok)
        if counted is None:
            counted = spmd.COUNTER.snapshot()["bytes"]
        if lg.shape[-1] != cfg.vocab_size:
            lg = spmd.all_gather(spmd.layout_of(mesh), "model", lg, -1,
                                 count=False)
        ids.append(int(tok))
        logits.append(lg.numpy().copy())
    return {"ids": ids, "logits": np.stack(logits), "counted": counted}


def moe_ssm4(rank, world_size, init_method, weights, opt_states, caches,
             long_caches):
    """Mamba2, MoE and Adafactor across 4 ranks: each rank's placed
    blocks of a reference train state and of a random cache (batch 4,
    and batch 1 with its KV slots over 'data'), on (2, 2), (1, 4) and
    (4, 1); two train steps at accum 1 and 2; mixtral at a capacity
    factor that drops, on (2, 2) and (4, 1); reduced llama and mixtral on
    the three-axis meshes; `serve_lm` on (1, 4) and (2, 2); batch-1
    decode from a random cache on (4, 1) and (2, 2); `init_blocks`'
    leaf-by-leaf draw beside the whole tree cut to blocks."""
    join(rank, world_size, init_method)
    try:
        out = {"layout": {}, "train": {}, "serve": {}, "long": {}}
        meshes = {s: lmesh.rank_mesh(s, device=CPU) for s in MESHES}
        meshes.update({s: lmesh.rank_mesh(s, AXES3, device=CPU)
                       for s in MESHES3})

        def keep(got):
            if rank:
                for part in WHOLE:
                    got.pop(part)
            return got

        for arch in MOE_SSM:
            cfg = f32(arch)
            full = {"params": tparams.from_reference(weights[arch], CPU),
                    "opt": tparams.from_reference(opt_states[arch], CPU),
                    "step": torch.zeros((), dtype=torch.int32)}
            cache = tparams.from_reference(caches[arch], CPU)
            spec = lm.cache_spec(cfg, CACHE_BATCH, CACHE_LEN)
            batch = lm_batch(cfg)
            for shape in MESHES:
                mesh = meshes[shape]
                placed = shd.place(full, tsteps.train_state_specs(cfg)[1](
                    mesh))
                c_placed = shd.place(cache, shd.cache_shardings(
                    mesh, cfg, spec, seq_shard=False))
                out["layout"][arch, shape] = {
                    "state": blocks(placed), "cache": blocks(c_placed),
                    "position": shd.mesh_position(mesh)}
                for accum in ACCUMS:
                    out["train"][arch, shape, accum] = keep(train(
                        cfg, mesh, weights[arch], batch, accum))
            for shape in SERVE_MESHES:
                rec = tserve.serve_lm(cfg, **SERVE, device=CPU,
                                      mesh=meshes[shape])
                out["serve"][arch, shape] = rec["ids"].numpy()
        cfg = f32(DROP_ARCH, capacity_factor=DROP_FACTOR)
        for shape in DROP_MESHES:
            out["train"]["drop", shape, 2] = keep(train(
                cfg, meshes[shape], weights[DROP_ARCH], lm_batch(cfg), 2))
        arch, changes, shape = UNEVEN
        cfg = f32(arch, **changes)
        out["train"]["uneven", shape, 1] = keep(train(
            cfg, meshes[shape], weights["uneven"], lm_batch(cfg), 1))
        out["serve"]["uneven", shape] = tserve.serve_lm(
            cfg, **SERVE, device=CPU, mesh=meshes[shape])["ids"].numpy()
        for arch in THREE:
            cfg = f32(arch)
            for shape in MESHES3:
                out["train"][arch, shape, 1] = keep(train(
                    cfg, meshes[shape], weights[arch], lm_batch(cfg), 1))
        for arch in LONG:
            cfg = f32(arch)
            spec = lm.cache_spec(cfg, 1, LONG_CAP)
            for shape in LONG_MESHES:
                mesh = meshes[shape]
                out["layout"]["long", arch, shape] = {
                    "cache": blocks(shd.place(
                        tparams.from_reference(long_caches[arch], CPU),
                        shd.cache_shardings(mesh, cfg, spec,
                                            seq_shard=True))),
                    "position": shd.mesh_position(mesh)}
                out["long"][arch, shape] = decode_long(cfg, mesh,
                                                       long_caches[arch])
        cfg = f32(INIT_ARCH)
        specs = lm.param_specs(cfg)
        sh = shd.param_shardings(meshes[INIT_MESH], specs)
        out["init"] = (blocks(shd.init_blocks(specs, 2, sh))
                       == blocks(shd.shard(tparams.tree_init(
                           specs, seed=2, device=CPU), sh)))
        return out
    finally:
        process.finalize()
