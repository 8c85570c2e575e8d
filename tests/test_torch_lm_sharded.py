"""The port's sharded LM step across torch.distributed ranks (FSDP over
'data', tensor parallelism over 'model'), on the CPU, against the
reference.

Two spawns of gloo ranks (`process.launch`, each under a deadline; their
bodies are in the jax-free `_mp_lm_ranks.py`) run the six dense configs
reduced and in float32, while this process runs the reference:

- 4 ranks (`world4`), on the meshes (2, 2), (1, 4) and (4, 1) of one
  rank a device: each rank's blocks of a reference train state (weights
  and AdamW moments) and of a random decode cache, placed by
  `sharding.place`, held bitwise against the slices that the reference's
  `param_shardings` / `opt_state_shardings` / `cache_shardings` give that
  device (``NamedSharding.devices_indices_map`` on 4 forced host devices,
  in a subprocess); two sharded train steps at accum 1 and 2 from the
  reference's weights on an 8-row batch, held against the reference's
  jitted one-device step within 1e-4 x max(1, |ref|) (loss, its parts,
  `grad_norm`, and the loss one update later), the gathered new
  parameters within 1e-5 of each leaf's norm, and each rank's resident
  state bytes equal to `local_bytes`; the collective bytes one step counts
  on (2, 2) and (1, 4) equal to the dry-run's count for that cell and
  mesh; `serve_lm` of the five decoders on (1, 4) and (2, 2) against the
  one-process ids; a checkpoint written on (2, 2) restored on (1, 4) and
  in one process, gathered bitwise equal;
- 2 ranks (`world2`): a (1, 1) mesh of each rank's own device under the
  group (no collective) bitwise equal to the one-process step, for all
  ten configs (the Mamba2, MoE and Adafactor ones are held on split
  meshes in `test_torch_lm_sharded_moe_ssm.py`).

The reference's jitted step also runs on the forced 4-device mesh for
reduced llama on (2, 2) (the subprocess), and the sharded step is held
against that too.
"""

import concurrent.futures
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
from repro.models import params as rparams
from repro.training import steps as rsteps
from repro_torch.distributed import checkpoint
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim.optimizers import tree_map, tree_paths
from repro_torch.training import sharding as shd

SPAWN_S = 300.0        # a hang guard: the file takes ~60 s on one worker
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-4
PARAM_TOL = 1e-5


def rcfg(arch):
    import dataclasses
    return dataclasses.replace(rc.reduced(rc.get(arch)), dtype="float32")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_state(arch):
    """The reference's weights (seed 1) and its AdamW state's structure
    holding distinct nonzero moments (0.1 p and p^2), as numpy trees."""
    cfg = rcfg(arch)
    p = np_tree(rparams.tree_init(rlm.param_specs(cfg), seed=1))
    s = rsteps.make_optimizer(cfg.optimizer).init(p)
    s = {"m": jax.tree_util.tree_map(lambda x: x * np.float32(0.1), p),
         "v": jax.tree_util.tree_map(lambda x: x * x, p)} \
        if set(s) == {"m", "v"} else np_tree(s)
    return p, s


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

out = {"slices": {}}
for arch in R.DENSE:
    cfg = dataclasses.replace(rc.reduced(rc.get(arch)), dtype="float32")
    state_sds, sh_fn = rsteps.train_state_specs(cfg)
    cache = rlm.cache_spec(cfg, R.CACHE_BATCH, R.CACHE_LEN)
    for shape in R.MESHES:
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        out["slices"][arch, shape] = {
            "state": named(state_sds, sh_fn(mesh), mesh),
            "cache": named(cache, rshd.cache_shardings(mesh, cfg, cache,
                                                       seq_shard=False),
                           mesh)}
# the reference's own step on the 4-device mesh, reduced llama on (2, 2)
cfg = dataclasses.replace(rc.reduced(rc.get("llama3.2-1b")), dtype="float32")
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
try:
    state_sds, sh_fn = rsteps.train_state_specs(cfg)
    p = rparams.tree_init(rlm.param_specs(cfg), seed=1)
    opt, step = rsteps.make_train_step(cfg, chunk=R.CHUNK)
    state = {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}
    state = jax.device_put(state, sh_fn(mesh))
    batch = {k: jnp.asarray(v) for k, v in R.lm_batch(cfg).items()}
    batch = jax.device_put(batch, {k: NamedSharding(mesh, rshd.data_pspec(
        mesh, v.ndim, batch_dim=1 if k == "positions" else 0))
        for k, v in batch.items()})
    with jax.sharding.use_mesh(mesh) if hasattr(jax.sharding, "use_mesh") else mesh:
        j = jax.jit(step)
        state, m0 = j(state, batch)
        state, m1 = j(state, batch)
    out["mesh_step"] = ({k: float(v) for k, v in m0.items()}, float(m1["loss"]))
except Exception as e:          # recorded, and the test says what failed
    out["mesh_step"] = repr(e)[:300]
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's subprocess on 4 forced host devices, started first
    so that it runs beside the spawns; `reference` waits for it."""
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


def one_device_reference(arch, weights):
    """The reference's jitted one-device step, two steps at accum 1 and
    2: step 0's metrics, the loss one update later, the new parameters."""
    cfg = rcfg(arch)
    p = jax.tree_util.tree_map(jnp.asarray, weights)
    batch = {k: jnp.asarray(v) for k, v in R.lm_batch(cfg).items()}
    out = {}
    for accum in R.ACCUMS:
        opt, step = rsteps.make_train_step(cfg, chunk=R.CHUNK, accum=accum)
        state = {"params": p, "opt": opt.init(p),
                 "step": jnp.zeros((), jnp.int32)}
        j = jax.jit(step)
        state, m0 = j(state, batch)
        new = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
               jax.tree_util.tree_leaves_with_path(state["params"])}
        _, m1 = j(state, batch)
        out[accum] = ({k: float(v) for k, v in m0.items()},
                      float(m1["loss"]), new)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, reference_run):
    """Both spawns' results and the reference's one-device steps,
    computed here while the ranks run."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    states = {a: ref_state(a) for a in R.DENSE + R.MOE_SSM}
    weights = {a: s[0] for a, s in states.items()}
    caches = {a: R.random_cache(R.f32(a)) for a in R.DENSE}

    def spawns():
        return (process_launch(R.world4, 4, (weights, {a: states[a][1] for a
                                                       in R.DENSE},
                                             caches, ckpt)),
                process_launch(R.world2, 2, (weights,)))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(spawns)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # the ranks share the cores
        try:
            ref = {a: one_device_reference(a, weights[a]) for a in R.DENSE}
            served = {a: tserve.serve_lm(R.f32(a), **R.SERVE, device="cpu")
                      for a in R.DECODERS}
        finally:
            torch.set_num_threads(threads)
        four, two = spawned.result()
    return {"four": four, "two": two, "ref": ref, "served": served,
            "weights": weights, "opt": {a: s[1] for a, s in states.items()},
            "caches": caches, "ckpt": ckpt}


def process_launch(fn, n, args):
    from repro_torch.distributed import process
    return process.launch(fn, n, args, timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def close(got, want, tol=TOL):
    return abs(got - want) <= tol * max(1.0, abs(want))


def sha(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def full_state(run, arch) -> dict:
    return {n: np.asarray(t) for n, t in tree_paths(
        {"params": run["weights"][arch], "opt": run["opt"][arch],
         "step": np.zeros((), np.int32)})}


LAYOUT_CASES = [(a, s) for a in R.DENSE for s in R.MESHES]


@pytest.mark.parametrize("arch,shape", LAYOUT_CASES)
def test_blocks_are_the_reference_devices_slices(run, reference, arch,
                                                 shape):
    """Every rank's block of every parameter, AdamW moment and cache leaf
    is bitwise the slice `devices_indices_map` gives its device."""
    want = reference["slices"][arch, shape]
    full = full_state(run, arch)
    cache = {n: np.asarray(t) for n, t in tree_paths(run["caches"][arch])}
    for rank, got in enumerate(run["four"]):
        lay = got["layout"][arch, shape]
        k = int(np.ravel_multi_index(lay["position"], shape))
        assert k == rank
        for part, arrays in (("state", full), ("cache", cache)):
            assert set(lay[part]) == set(want[part]) == set(arrays)
            for name, per_device in want[part].items():
                idx = tuple(slice(a, b) for a, b in per_device[k])
                block = arrays[name][idx]
                assert lay[part][name] == (block.shape, sha(block)), \
                    (part, name, rank)


TRAIN_CASES = [(a, s, k) for a in R.DENSE for s in R.MESHES
               for k in R.ACCUMS]


@pytest.mark.parametrize("arch,shape,accum", TRAIN_CASES)
def test_sharded_step_matches_the_reference(run, arch, shape, accum):
    m0, loss1, new = run["ref"][arch][accum]
    for rank, ranks in enumerate(run["four"]):
        got = ranks["train"][arch, shape, accum]
        assert set(got["m0"]) == set(m0)
        for k in m0:
            assert close(got["m0"][k], m0[k]), (k, rank, got["m0"][k],
                                                m0[k])
        assert close(got["loss1"], loss1), (got["loss1"], loss1)
        assert got["resident"] == got["local"]
    params = run["four"][0]["train"][arch, shape, accum]["params"]
    assert set(params) == set(new)
    for name, want in new.items():
        err = np.linalg.norm(params[name] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert err <= PARAM_TOL, (name, err)


def test_sharded_step_matches_the_reference_on_its_mesh(run, reference):
    """Reduced llama on (2, 2) against the reference's jitted step on the
    same mesh of 4 forced host devices."""
    got = reference["mesh_step"]
    assert not isinstance(got, str), got
    m0, loss1 = got
    ours = run["four"][0]["train"]["llama3.2-1b", (2, 2), 1]
    for k in m0:
        assert close(ours["m0"][k], m0[k]), k
    assert close(ours["loss1"], loss1)


@pytest.mark.parametrize("arch", R.DENSE + R.MOE_SSM)
def test_one_by_one_mesh_is_the_one_process_step_bitwise(run, arch):
    for rank in run["two"]:
        got = rank["one"][arch]
        assert got["metrics"] and got["params"]
        assert not any(got["counted"].values())
        assert np.isfinite(got["loss"])


@pytest.mark.parametrize("shape", R.BYTES_MESHES)
def test_counted_bytes_equal_the_dry_runs(run, shape):
    cfg = R.f32("llama3.2-1b")
    want = dryrun.count_collectives(cfg, "train", R.BATCH, R.SEQ,
                                    abstract_mesh(shape, ("data", "model")),
                                    chunk=R.CHUNK)
    for rank in run["four"]:
        got = rank["train"]["llama3.2-1b", shape, 1]["counted"]
        assert got == want
    assert sum(want.values()) > 0


SERVE_CASES = [(a, s) for a in R.DECODERS for s in R.SERVE_MESHES]


@pytest.mark.parametrize("arch,shape", SERVE_CASES)
def test_sharded_serving_generates_the_one_process_ids(run, arch, shape):
    want = run["served"][arch]
    for rank in run["four"]:
        got = rank["serve"][arch, shape]
        np.testing.assert_array_equal(got["ids"], want["ids"].numpy())
        assert got["cache"] == got["want"]
    gathered = run["four"][0]["serve"][arch, shape]["gathered"]
    for name, t in tree_paths(want["cache"]):
        a = t.numpy()
        assert gathered[name].shape == a.shape
        np.testing.assert_allclose(gathered[name], a, rtol=TOL, atol=TOL)


def test_checkpoint_moves_between_meshes_and_into_one_process(run):
    for rank in run["four"]:
        ck = rank["ckpt"]
        assert ck["restored"] == ck["written"]
        assert ck["restored_blocks"] == ck["want_blocks"]
    cfg = R.f32(R.CKPT_ARCH)
    from repro_torch.optim import make_optimizer
    params = tparams.tree_abstract(tlm.param_specs(cfg))
    like = {"params": params, "opt": make_optimizer("adamw").init(params),
            "step": torch.zeros((), dtype=torch.int32)}
    step, tree = checkpoint.restore(run["ckpt"], like,
                                    placement_fn=lambda n, leaf: "cpu")
    assert step == 1
    written = run["four"][0]["ckpt"]["written"]
    assert {n: (tuple(t.shape), sha(t.numpy()))
            for n, t in tree_paths(tree)} == written
