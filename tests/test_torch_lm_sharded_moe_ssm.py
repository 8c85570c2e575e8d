"""The port's sharded LM step for Mamba2, mixture-of-experts and
Adafactor, and long-context decode, across torch.distributed ranks on the
CPU, against the reference.

One spawn of 4 gloo ranks (`process.launch` under a deadline; its body,
`moe_ssm4`, is in the jax-free `_mp_lm_ranks.py`) runs mamba2-130m,
mixtral-8x7b, kimi-k2 and jamba-1.5-large reduced and in float32, while
this process runs the reference and the port's one-process paths:

- each rank's blocks of a reference train state (weights, AdamW moments
  or Adafactor's ``vr``/``vc``/``v``, all distinct) and of a random
  decode cache (``conv``, ``ssm``, ``k``, ``v``), placed by
  `sharding.place` on (2, 2), (1, 4) and (4, 1), held bitwise against the
  slices ``NamedSharding.devices_indices_map`` gives that device (the
  reference on 4 forced host devices, in a subprocess), and a batch-1
  cache with its KV slots over 'data' (``seq_shard=True``) the same way;
- two sharded train steps at accum 1 and 2 from the reference's weights
  on an 8-row batch, against the reference's jitted one-device step
  within 1e-4 x max(1, |ref|) (loss, ``ce``, ``aux``, ``grad_norm``, the
  loss one update later), the gathered parameters after the first
  update within 1e-5 of each leaf's norm, and after the second (which
  reads back the first's moments) with the optimizer state it writes
  within 1e-4, each rank's resident state bytes equal to
  `local_bytes`; mixtral also at a capacity factor of 0.5, where the
  reference's own routing drops assignments, on (2, 2) and (4, 1) at
  accum 2; reduced llama and mixtral on the ('pod', 'data', 'model')
  meshes (2, 1, 2) and (2, 2, 1); where the reference's jitted step runs
  on the forced 4-device (2, 2) mesh, against that too;
- `serve_lm` on (1, 4) and (2, 2) against the one-process ids;
- batch-1 decode from a random cache at length 40 of 64 slots on (4, 1)
  and (2, 2), for five decoders (local rings, global layers, Mamba2
  states), against the one-process ids and logits and the reference's
  jitted serve step's;
- Mamba2 with two heads on a 4-way 'model' axis (columns split, heads
  not), the train step against the reference's and serving against one
  process's;
- the collective bytes one step counts against `dryrun.count_collectives`
  (a Mamba2 and an MoE train step on (2, 2) and (1, 4), batch-1 decode
  on (4, 1)); `sharding.init_blocks` against the whole tree cut to
  blocks; MoE's per-expert counts against ``torch.bincount``.
"""

import concurrent.futures
import dataclasses
import hashlib
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _mp_lm_ranks as R
from repro import configs as rc
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import params as rparams
from repro.training import steps as rsteps
from repro_torch.distributed import process
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import moe as tmoe
from repro_torch.optim.optimizers import tree_paths

SPAWN_S = 300.0          # a hang guard: the file takes ~90 s on one worker
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-4
PARAM_TOL = 1e-5
# the moments are the gradients' (squared, for the second ones), which
# agree to the metrics' TOL, and the second update reads them back: the
# state and the parameters after that update (zero-initialized biases,
# whose norm is their two updates, among them) are held to STATE_TOL;
# the parameters after the first update, about the gradients' signs, to
# PARAM_TOL (the port's one-process step is as far from the reference)
STATE_TOL = TOL


def rcfg(arch, **changes):
    return dataclasses.replace(rc.reduced(rc.get(arch)), dtype="float32",
                               **changes)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_state(arch):
    """The reference's weights (seed 1) and its optimizer state's
    structure holding distinct nonzero entries, as numpy trees."""
    cfg = rcfg(arch)
    p = np_tree(rparams.tree_init(rlm.param_specs(cfg), seed=1))
    rng = np.random.default_rng(11)
    s = np_tree(rsteps.make_optimizer(cfg.optimizer).init(p))
    return p, jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), s)


REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[3])
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro import configs as rc
from repro.models import lm as rlm, params as rparams
from repro.training import sharding as rshd, steps as rsteps
import _mp_lm_ranks as R

def slices(sh, shape, mesh):
    m = sh.devices_indices_map(tuple(shape))
    return [tuple((s.start, s.stop) for s in m[d]) for d in mesh.devices.flat]

def named(tree, shardings, mesh):
    out = {}
    for (path, sds), sh in zip(jax.tree_util.tree_leaves_with_path(tree),
                               jax.tree_util.tree_leaves(shardings)):
        out[jax.tree_util.keystr(path)] = slices(sh, sds.shape, mesh)
    return out

def cfg_of(arch):
    return dataclasses.replace(rc.reduced(rc.get(arch)), dtype="float32")

def mesh_of(shape):
    return Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))

out = {"slices": {}, "mesh_step": {}}
for arch in R.MOE_SSM:
    cfg = cfg_of(arch)
    state_sds, sh_fn = rsteps.train_state_specs(cfg)
    cache = rlm.cache_spec(cfg, R.CACHE_BATCH, R.CACHE_LEN)
    for shape in R.MESHES:
        mesh = mesh_of(shape)
        out["slices"][arch, shape] = {
            "state": named(state_sds, sh_fn(mesh), mesh),
            "cache": named(cache, rshd.cache_shardings(mesh, cfg, cache,
                                                       seq_shard=False),
                           mesh)}
for arch in R.LONG:
    cfg = cfg_of(arch)
    cache = rlm.cache_spec(cfg, 1, R.LONG_CAP)
    for shape in R.LONG_MESHES:
        mesh = mesh_of(shape)
        out["slices"]["long", arch, shape] = {"cache": named(
            cache, rshd.cache_shardings(mesh, cfg, cache, seq_shard=True),
            mesh)}
# the reference's own step on the 4-device (2, 2) mesh
for arch in R.MOE_SSM:
    cfg = cfg_of(arch)
    mesh = mesh_of((2, 2))
    try:
        state_sds, sh_fn = rsteps.train_state_specs(cfg)
        p = rparams.tree_init(rlm.param_specs(cfg), seed=1)
        opt, step = rsteps.make_train_step(cfg, chunk=R.CHUNK)
        state = {"params": p, "opt": opt.init(p),
                 "step": jnp.zeros((), jnp.int32)}
        state = jax.device_put(state, sh_fn(mesh))
        batch = {k: jnp.asarray(v) for k, v in R.lm_batch(cfg).items()}
        batch = jax.device_put(batch, {k: NamedSharding(mesh, rshd.data_pspec(
            mesh, v.ndim)) for k, v in batch.items()})
        with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh:
            j = jax.jit(step)
            state, m0 = j(state, batch)
            state, m1 = j(state, batch)
        out["mesh_step"][arch] = ({k: float(v) for k, v in m0.items()},
                                  float(m1["loss"]))
    except Exception as e:      # recorded, and the test says what failed
        out["mesh_step"][arch] = repr(e)[:300]
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's subprocess on 4 forced host devices, started first
    so that it runs beside the spawn; `reference` waits for it."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.pkl")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, SRC, path,
         os.path.dirname(__file__)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def named(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def one_device_reference(cfg, weights, accum):
    """The reference's jitted one-device step, twice: step 0's metrics,
    the loss one update later, and what `R.train` returns whole: the
    parameters after each update, the optimizer state after the
    second."""
    p = jax.tree_util.tree_map(jnp.asarray, weights)
    batch = {k: jnp.asarray(v) for k, v in R.lm_batch(cfg).items()}
    opt, step = rsteps.make_train_step(cfg, chunk=R.CHUNK, accum=accum)
    state = {"params": p, "opt": opt.init(p),
             "step": jnp.zeros((), jnp.int32)}
    j = jax.jit(step)
    state, m0 = j(state, batch)
    new = named(state["params"])
    state, m1 = j(state, batch)
    return ({k: float(v) for k, v in m0.items()}, float(m1["loss"]),
            {"params": new, "params2": named(state["params"]),
             "opt2": named(state["opt"])})


def reference_decode(cfg, cache):
    """The reference's jitted serve step, `R.LONG_GEN` greedy steps of
    token 7 from `cache` (numpy, batch 1) with seed-0 weights, as
    `R.decode_long` runs the port's: the ids and the logits."""
    p = rparams.tree_init(rlm.param_specs(cfg), seed=0)
    step = jax.jit(rsteps.make_serve_step(cfg))
    c = jax.tree_util.tree_map(jnp.asarray, cache)
    tok = jnp.full((1, 1), 7, jnp.int32)
    ids, logits = [], []
    for _ in range(R.LONG_GEN):
        tok, lg, c = step(p, c, tok)
        ids.append(int(tok[0, 0]))
        logits.append(np.asarray(lg))
    return {"ids": ids, "logits": np.stack(logits)}


def reference_drops(cfg, weights, accum) -> int:
    """Assignments the reference's own routing drops over the step's
    microbatches: its `moe_ffn`'s top-k counts beyond its `capacity`,
    from its forward run eagerly (no remat)."""
    cfg = dataclasses.replace(cfg, remat=False)
    p = jax.tree_util.tree_map(jnp.asarray, weights)
    batch = R.lm_batch(cfg)
    b = batch["labels"].shape[0]
    dropped, route = [], rmoe.moe_ffn

    def spy(pp, c, x, act):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ pp["router"], -1)
        _, idx = jax.lax.top_k(probs, c.experts_per_token)
        counts = np.bincount(np.asarray(idx).ravel(), minlength=c.n_experts)
        dropped.append(int(np.maximum(
            counts - rmoe.capacity(c, xf.shape[0]), 0).sum()))
        return route(pp, c, x, act)

    rmoe.moe_ffn = spy
    try:
        for i in range(accum):
            rows = slice(i * b // accum, (i + 1) * b // accum)
            rlm.loss_fn(cfg, p, {k: jnp.asarray(v[rows])
                                 for k, v in batch.items()})
    finally:
        rmoe.moe_ffn = route
    return sum(dropped)


@pytest.fixture(scope="module")
def run(reference_run):
    """The spawn's results and the reference's and the port's
    one-process runs, computed here while the ranks run."""
    states = {a: ref_state(a) for a in R.MOE_SSM}
    weights = {a: s[0] for a, s in states.items()}
    weights["llama3.2-1b"] = np_tree(rparams.tree_init(
        rlm.param_specs(rcfg("llama3.2-1b")), seed=1))
    uneven = rcfg(R.UNEVEN[0], **R.UNEVEN[1])
    weights["uneven"] = np_tree(rparams.tree_init(rlm.param_specs(uneven),
                                                  seed=1))
    caches = {a: R.random_cache(R.f32(a)) for a in R.MOE_SSM}
    long_caches = {a: R.long_cache(R.f32(a)) for a in R.LONG}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(process.launch, R.moe_ssm4, 4, (
            weights, {a: s[1] for a, s in states.items()}, caches,
            long_caches), timeout_s=SPAWN_S)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # the ranks share the cores
        try:
            drop_cfg = rcfg(R.DROP_ARCH, capacity_factor=R.DROP_FACTOR)
            jobs = {(a, k): (rcfg(a), a, k) for a in R.MOE_SSM
                    for k in R.ACCUMS}
            jobs["llama3.2-1b", 1] = (rcfg("llama3.2-1b"), "llama3.2-1b", 1)
            jobs["drop", 2] = (drop_cfg, R.DROP_ARCH, 2)
            jobs["uneven", 1] = (uneven, "uneven", 1)
            # before the threads trace: it swaps the reference's moe_ffn
            drops = reference_drops(drop_cfg, weights[R.DROP_ARCH], 2)
            # XLA compiles off the GIL: the jitted steps in a few threads,
            # the costliest (jamba's) first
            with concurrent.futures.ThreadPoolExecutor(3) as refs:
                futures = {key: refs.submit(one_device_reference, c,
                                            weights[a], k)
                           for key, (c, a, k) in sorted(
                               jobs.items(),
                               key=lambda j: j[1][1] != R.MOE_SSM[-1])}
                long_refs = {a: refs.submit(reference_decode, rcfg(a),
                                            long_caches[a])
                             for a in R.LONG}
                ref = {key: f.result() for key, f in futures.items()}
                ref_long = {a: f.result() for a, f in long_refs.items()}
            served = {a: tserve.serve_lm(R.f32(a), **R.SERVE, device="cpu")
                      for a in R.MOE_SSM}
            served["uneven"] = tserve.serve_lm(
                R.f32(R.UNEVEN[0], **R.UNEVEN[1]), **R.SERVE, device="cpu")
            decoded = {a: R.decode_long(R.f32(a), None, long_caches[a])
                       for a in R.LONG}
        finally:
            torch.set_num_threads(threads)
        four = spawned.result()
    return {"four": four, "ref": ref, "drops": drops, "served": served,
            "decoded": decoded, "ref_long": ref_long, "weights": weights,
            "opt": {a: s[1] for a, s in states.items()}, "caches": caches,
            "long_caches": long_caches}


def close(got, want, tol=TOL):
    return abs(got - want) <= tol * max(1.0, abs(want))


def sha(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def held(four, key, want):
    """Every rank's metrics of train case `key` within the tolerance of
    the reference's `want` (step 0's metrics and the next loss), its
    resident bytes its `local_bytes`; rank 0's gathered parameters after
    each update and optimizer state after the second (AdamW's ``mu`` and
    ``nu``, Adafactor's ``vr``, ``vc`` and ``v``, read back from the
    first update) within `PARAM_TOL` and `STATE_TOL` of each leaf's
    norm."""
    m0, loss1 = want[:2]
    for rank, ranks in enumerate(four):
        got = ranks["train"][key]
        assert set(got["m0"]) == set(m0)
        for k in m0:
            assert close(got["m0"][k], m0[k]), (k, rank, got["m0"][k],
                                                m0[k])
        assert close(got["loss1"], loss1), (got["loss1"], loss1)
        assert got["resident"] == got["local"]
    for part, whole in want[2].items():
        got = four[0]["train"][key][part]
        assert set(got) == set(whole), part
        tol = PARAM_TOL if part == "params" else STATE_TOL
        for name, w in whole.items():
            err = np.linalg.norm(got[name] - w) / max(
                np.linalg.norm(w), 1e-30)
            assert err <= tol, (part, name, err)


def check_slices(four, key, want, arrays, shape):
    for rank, got in enumerate(four):
        lay = got["layout"][key]
        k = int(np.ravel_multi_index(lay["position"], shape))
        assert k == rank
        for part, full in arrays.items():
            assert set(lay[part]) == set(want[part]) == set(full)
            for name, per_device in want[part].items():
                idx = tuple(slice(a, b) for a, b in per_device[k])
                block = full[name][idx]
                assert lay[part][name] == (block.shape, sha(block)), \
                    (part, name, rank)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.MOE_SSM
                                        for s in R.MESHES])
def test_blocks_are_the_reference_devices_slices(run, reference, arch,
                                                 shape):
    """Every rank's block of every parameter, AdamW or Adafactor moment
    (``vr``/``vc`` whose shapes coincide included: kimi's d_model equals
    its d_ff) and cache leaf is bitwise the slice `devices_indices_map`
    gives its device."""
    full = {n: np.asarray(t) for n, t in tree_paths(
        {"params": run["weights"][arch], "opt": run["opt"][arch],
         "step": np.zeros((), np.int32)})}
    cache = {n: np.asarray(t) for n, t in tree_paths(run["caches"][arch])}
    check_slices(run["four"], (arch, shape),
                 reference["slices"][arch, shape],
                 {"state": full, "cache": cache}, shape)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.LONG
                                        for s in R.LONG_MESHES])
def test_long_context_cache_blocks_are_the_reference_devices_slices(
        run, reference, arch, shape):
    """A batch-1 cache's KV slots split over 'data' (the ring of a local
    layer too), its Mamba2 states replicated over 'data'."""
    cache = {n: np.asarray(t) for n, t in
             tree_paths(run["long_caches"][arch])}
    check_slices(run["four"], ("long", arch, shape),
                 reference["slices"]["long", arch, shape],
                 {"cache": cache}, shape)


@pytest.mark.parametrize("arch,shape,accum", [
    (a, s, k) for a in R.MOE_SSM for s in R.MESHES for k in R.ACCUMS])
def test_sharded_step_matches_the_reference(run, arch, shape, accum):
    held(run["four"], (arch, shape, accum), run["ref"][arch, accum])


@pytest.mark.parametrize("shape", R.DROP_MESHES)
def test_dropping_moe_step_matches_the_reference(run, shape):
    """Mixtral at capacity factor 0.5: the reference's routing drops
    assignments, and the sharded step drops the same ones (global
    capacity, global (token, k) order within each microbatch)."""
    assert run["drops"] > 0
    held(run["four"], ("drop", shape, 2), run["ref"]["drop", 2])


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.THREE
                                        for s in R.MESHES3])
def test_three_axis_mesh_matches_the_reference(run, arch, shape):
    """('pod', 'data', 'model') meshes of 4 ranks: MoE's global order
    over the combined batch axes, the 'pod' all-reduce of the FSDP
    gradients."""
    held(run["four"], (arch, shape, 1), run["ref"][arch, 1])


def test_mamba_heads_that_model_does_not_divide(run):
    """Two Mamba2 heads on (1, 4): each rank's columns of `wz`/`wx` are
    half a head, so `z` and `x` are gathered, every rank runs both heads
    and keeps its columns (mamba2-130m's 24 heads on a 16-way 'model'
    axis); train step and serving against the reference's and one
    process's."""
    shape = R.UNEVEN[2]
    held(run["four"], ("uneven", shape, 1), run["ref"]["uneven", 1])
    want = run["served"]["uneven"]["ids"].numpy()
    for rank in run["four"]:
        np.testing.assert_array_equal(rank["serve"]["uneven", shape], want)


@pytest.mark.parametrize("arch", R.MOE_SSM)
def test_sharded_step_matches_the_reference_on_its_mesh(run, reference,
                                                        arch):
    """Against the reference's jitted step on the (2, 2) mesh of 4
    forced host devices."""
    got = reference["mesh_step"][arch]
    assert not isinstance(got, str), got
    m0, loss1 = got
    ours = run["four"][0]["train"][arch, (2, 2), 1]
    for k in m0:
        assert close(ours["m0"][k], m0[k]), k
    assert close(ours["loss1"], loss1)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.MOE_SSM
                                        for s in R.SERVE_MESHES])
def test_sharded_serving_generates_the_one_process_ids(run, arch, shape):
    want = run["served"][arch]["ids"].numpy()
    for rank in run["four"]:
        np.testing.assert_array_equal(rank["serve"][arch, shape], want)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.LONG
                                        for s in R.LONG_MESHES])
def test_long_context_decode_matches_one_process(run, arch, shape):
    want = run["decoded"][arch]
    for rank in run["four"]:
        got = rank["long"][arch, shape]
        assert got["ids"] == want["ids"]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in R.LONG
                                        for s in R.LONG_MESHES])
def test_long_context_decode_matches_the_reference(run, arch, shape):
    """The sharded batch-1 decode (KV slots over 'data', owner-only
    writes, the flash-decoding combine) against the reference's jitted
    serve step on the same cache, weights and token."""
    want = run["ref_long"][arch]
    for rank in run["four"]:
        got = rank["long"][arch, shape]
        assert got["ids"] == want["ids"]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("mamba2-130m", "mixtral-8x7b")
    for s in R.BYTES_MESHES])
def test_counted_train_bytes_equal_the_dry_runs(run, arch, shape):
    want = dryrun.count_collectives(R.f32(arch), "train", R.BATCH, R.SEQ,
                                    abstract_mesh(shape, ("data", "model")),
                                    chunk=R.CHUNK)
    for rank in run["four"]:
        assert rank["train"][arch, shape, 1]["counted"] == want
    assert sum(want.values()) > 0


@pytest.mark.parametrize("arch", R.LONG)
def test_counted_decode_bytes_equal_the_dry_runs(run, arch):
    want = dryrun.count_collectives(R.f32(arch), "decode", 1, R.LONG_CAP,
                                    abstract_mesh((4, 1), ("data", "model")))
    for rank in run["four"]:
        assert rank["long"][arch, (4, 1)]["counted"] == want
    assert sum(want.values()) > 0


def test_tree_init_leaf_by_leaf_is_the_whole_tree_cut(run):
    """`sharding.init_blocks` (seeded weights drawn into a rank's blocks a
    leaf a thread) bitwise `shard(tree_init(...))`."""
    assert all(rank["init"] for rank in run["four"])


@pytest.mark.parametrize("t,e,k", [(64, 4, 2), (257, 8, 2), (96, 384, 8)])
def test_expert_counts_equal_bincount_bitwise(t, e, k):
    g = torch.Generator().manual_seed(t)
    flat = torch.topk(torch.rand(t, e, generator=g), k, dim=-1)[1].reshape(-1)
    got = tmoe.expert_counts(flat, e)
    want = torch.bincount(flat, minlength=e)
    assert got.dtype == want.dtype and torch.equal(got, want)
    meta = tmoe.expert_counts(flat.to("meta"), e)
    assert meta.shape == (e,) and meta.dtype == torch.int64


def test_no_split_is_refused():
    """Nothing of the port refuses a split mesh for Mamba2, MoE,
    Adafactor or batch-1 decode any more."""
    root = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    text = f.read()
                assert "14a2" not in text and "refuse_unported" not in text, \
                    name
