"""The port's LM sharding rules (`training.sharding`), the LM half of
`launch.mesh` and the dry-run's abstract state (`training.steps`
`train_state_specs`/`input_specs`) on the CPU, against the reference's.

The reference side runs on ``jax.sharding.AbstractMesh``es (no devices),
the port on `launch.mesh.abstract_mesh`es of ``meta`` devices, at the
published widths of all ten configs. A `PartitionSpec` compares as the
tuple of its entries, which is the port's spec. Exact equality throughout.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as rc
from repro.configs.base import SHAPES as RSHAPES
from repro.configs.base import shape_applicable as r_applicable
from repro.models import lm as rlm
from repro.training import sharding as rshd
from repro.training import steps as rsteps
from repro_torch import configs as tc
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.optim.optimizers import tree_paths
from repro_torch.training import sharding as shd
from repro_torch.training import steps as tsteps

ARCHS = list(rc.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.abstract_mesh(shape, axes)


def ref_specs(tree) -> dict:
    """keystr -> the tuple of a reference NamedSharding tree's specs."""
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_leaves_with_path(tree)}


def port_specs(tree) -> dict:
    return {name: s.spec for name, s in tree_paths(tree)}


def ref_shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(tree)}


def port_shapes(tree) -> dict:
    return {name: (tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for name, s in tree_paths(tree)}


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_production_and_abstract_meshes(monkeypatch):
    cpu = torch.device("cpu")
    pod = tmesh.make_production_mesh(devices=[cpu] * 256)
    assert pod.shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True, devices=[cpu] * 512)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.devices.shape == (2, 16, 16)
    ab = tmesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert ab.devices.size == 512
    assert set(ab.devices.flat) == {torch.device("meta")}
    ref = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert dict(ref.shape) == ab.shape
    for m in (pod, multi):
        assert tmesh.batch_axes(m) == rshd.batch_axes(
            AbstractMesh(tuple(m.shape.values()), m.axis_names))
        assert tmesh.model_axis(m) == "model"
    assert shd.batch_axes is tmesh.batch_axes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_production_mesh()       # the card's devices by default


# ---------------------------------------------------------------------------
# parameter shardings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_the_reference(arch, mesh):
    rmesh, tmesh_ = meshes(mesh)
    cfg_r, cfg_t = rc.get(arch), tc.get(arch)
    for stacked in (False, True):
        r_tree = rlm.param_specs(cfg_r, stacked=stacked)
        t_tree = tlm.param_specs(cfg_t, stacked=stacked)
        want = rshd.param_shardings(rmesh, r_tree)
        got = shd.param_shardings(tmesh_, t_tree)
        assert port_specs(got) == ref_specs(want)
        # leaf for leaf: spec_pspec, and the block one device holds
        ref_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
        for (name, s), (path, ws) in zip(
                tree_paths(t_tree),
                jax.tree_util.tree_leaves_with_path(want)):
            assert name == jax.tree_util.keystr(path)
            assert shd.spec_pspec(tmesh_, s) == tuple(ws.spec)
            assert shd.local_shape(s.shape, ws.spec, tmesh_) \
                == tuple(ws.shard_shape(s.shape))
        assert len(ref_leaves) == len(tree_paths(t_tree))


def test_spec_pspec_fallback_and_dedup():
    from repro.models.params import ParamSpec as RSpec
    from repro_torch.models.params import ParamSpec as TSpec
    rmesh, tmesh_ = meshes("16x16")
    for shape, axes in (((8, 64, 128), ("experts", "embed", "mlp")),
                        ((16, 64, 128), ("experts", "embed", "mlp")),
                        ((7, 128), ("heads", None)),
                        ((2048, 4, 256), ("embed", "heads", None)),
                        ((64, 48), ("embed", "vocab"))):
        assert shd.spec_pspec(tmesh_, TSpec(shape, axes)) == tuple(
            rshd.spec_pspec(rmesh, RSpec(shape, axes)))
    # experts win 'model' over mlp; 4 heads fall back on a 16-way axis
    assert shd.spec_pspec(tmesh_, TSpec((16, 64, 128),
                                        ("experts", "embed", "mlp"))) \
        == ("model", "data", None)
    assert shd.spec_pspec(tmesh_, TSpec((2048, 4, 256),
                                        ("embed", "heads", None))) \
        == ("data", None, None)


# ---------------------------------------------------------------------------
# decode caches, train state, inputs
# ---------------------------------------------------------------------------

DECODE = [a for a in ARCHS if rc.get(a).supports_decode]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", DECODE)
def test_cache_shardings_match_the_reference(arch, mesh):
    rmesh, tmesh_ = meshes(mesh)
    cfg_r, cfg_t = rc.get(arch), tc.get(arch)
    for b, seq in ((128, 32768), (1, 524288)):
        for stacked in (False, True):
            r_cache = rlm.cache_spec(cfg_r, b, seq, stacked=stacked)
            t_cache = tlm.cache_spec(cfg_t, b, seq, stacked=stacked)
            for seq_shard in (False, True):
                want = rshd.cache_shardings(rmesh, cfg_r, r_cache,
                                            seq_shard=seq_shard)
                got = shd.cache_shardings(tmesh_, cfg_t, t_cache,
                                          seq_shard=seq_shard)
                assert port_specs(got) == ref_specs(want), (b, stacked,
                                                            seq_shard)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_the_reference(arch, mesh):
    """The whole train state: parameters, optimizer state (AdamW's m and
    v, or Adafactor's factored rows and columns inheriting the prefix)
    and the step, in shapes, dtypes and shardings."""
    rmesh, tmesh_ = meshes(mesh)
    r_sds, r_fn = rsteps.train_state_specs(rc.get(arch))
    t_sds, t_fn = tsteps.train_state_specs(tc.get(arch))
    assert port_shapes(t_sds) == ref_shapes(r_sds)
    want, got = r_fn(rmesh), t_fn(tmesh_)
    assert port_specs(got) == ref_specs(want)
    assert port_specs(got["opt"]) == ref_specs(want["opt"])


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_opt_state_shardings_under_each_optimizer(kind):
    from repro.optim import make_optimizer as r_make
    from repro_torch.models.params import tree_abstract
    from repro_torch.optim import make_optimizer as t_make
    rmesh, tmesh_ = meshes("16x16")
    arch = "llama3.2-1b" if kind == "adamw" else "kimi-k2-1t-a32b"
    cfg_r, cfg_t = rc.get(arch), tc.get(arch)
    r_tree, t_tree = rlm.param_specs(cfg_r), tlm.param_specs(cfg_t)
    from repro.models.params import tree_sds as r_sds
    r_opt = jax.eval_shape(r_make(kind).init, r_sds(r_tree))
    t_opt = t_make(kind).init(tree_abstract(t_tree))
    want = rshd.opt_state_shardings(rmesh, r_tree, r_opt)
    got = shd.opt_state_shardings(tmesh_, t_tree, t_opt)
    assert port_specs(got) == ref_specs(want)
    if kind == "adafactor":     # factored stats drop the last / 2nd-last dim
        specs = port_specs(got)
        assert any(n.endswith("['vr']") for n in specs)
        assert any(n.endswith("['vc']") for n in specs)


CELLS = [(a, s) for a in ARCHS for s in SHAPES]
RUNNABLE = [(a, s) for a, s in CELLS if r_applicable(rc.get(a), s)[0]]


def test_forty_cells_thirty_four_runnable():
    runnable = [(a, s) for a, s in CELLS
                if shape_applicable(tc.get(a), s)[0]]
    assert len(CELLS) == 40 and len(runnable) == 34 == len(RUNNABLE)
    for a, s in CELLS:
        assert shape_applicable(tc.get(a), s) == r_applicable(rc.get(a), s)
    assert SHAPES == RSHAPES


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_specs_match_the_reference(arch, shape):
    r_in, r_fn = rsteps.input_specs(rc.get(arch), shape)
    t_in, t_fn = tsteps.input_specs(tc.get(arch), shape)
    assert port_shapes(t_in) == ref_shapes(r_in)
    for mesh in ("16x16", "2x16x16"):
        rmesh, tmesh_ = meshes(mesh)
        assert port_specs(t_fn(tmesh_)) == ref_specs(r_fn(rmesh))


# ---------------------------------------------------------------------------
# local_shape and place
# ---------------------------------------------------------------------------

def test_local_shape_and_local_bytes():
    _, m = meshes("2x16x16")
    assert shd.local_shape((256, 4096), (("pod", "data"), None), m) \
        == (8, 4096)
    assert shd.local_shape((2048, 8192), ("data", "model"), m) == (128, 512)
    assert shd.local_shape((7, 3), (None, None), m) == (7, 3)
    assert shd.local_shape((5,), (), m) == (5,)
    assert shd.local_shape((33,), ("model",), m) == (3,)   # ceil
    cfg = tc.get("llama3.2-1b")
    specs = tlm.param_specs(cfg)
    from repro_torch.models.params import tree_sds
    one = tmesh.make_debug_mesh((1, 1), devices=["cpu"])
    sds = tree_sds(specs)
    whole = sum(s.nbytes for _, s in tree_paths(sds))
    assert shd.local_bytes(sds, shd.param_shardings(one, specs)) == whole
    _, pod = meshes("16x16")      # embed over 'data', vocab over 'model'
    assert shd.local_bytes(sds, shd.param_shardings(pod, specs)) \
        < whole // 100


def test_place_stores_whole_leaves_on_a_one_device_mesh():
    cfg = tc.reduced(tc.get("llama3.2-1b"))
    specs = tlm.param_specs(cfg)
    from repro_torch.models.params import tree_init
    params = tree_init(specs, seed=0, device="cpu")
    mesh = tmesh.make_debug_mesh((2, 2), devices=["cpu"] * 4)
    sh = shd.param_shardings(mesh, specs)
    assert any(any(e is not None for e in s.spec)
               for _, s in tree_paths(sh))       # real splits requested
    placed = shd.place(params, sh)
    for (n, a), (m, b) in zip(tree_paths(params), tree_paths(placed)):
        assert n == m and b is a                 # whole, stored once
    assert shd.constrain_like_params(params, specs) is params


def test_place_refuses_a_split_over_distinct_devices():
    mesh = tmesh.make_mesh((1, 2), ("data", "model"), ["cpu", "meta"])
    from repro_torch.models.params import ParamSpec
    split = shd.NamedSharding(mesh, shd.spec_pspec(
        mesh, ParamSpec((4, 8), ("embed", "mlp"))))
    assert split.spec == ("data", "model")
    x = torch.ones(4, 8)
    with pytest.raises(NotImplementedError, match="process mesh"):
        shd.place({"w": x}, {"w": split})
    # a leaf no axis of size above 1 splits goes whole to the first device
    rep = shd.NamedSharding(mesh, ("data", None))
    assert shd.place([x], [rep])[0] is x
    assert shd.device_for(rep) == torch.device("cpu")
    np.testing.assert_array_equal(
        shd.local_shape((4, 8), split.spec, mesh), (4, 4))
