"""The port's checkpoints and elastic rescale against the reference's.

The reference's `tests/test_checkpoint.py` cases run on the port
(`repro_torch.distributed.checkpoint`); a checkpoint written by
`repro.distributed.checkpoint.save` restores in the port and one written
by the port restores in the reference (same step directories, leaf names
and dtypes, bfloat16 included). `ElasticStencilRun` on a pool of CPU
devices shrinks and grows a run bitwise equal to an uninterrupted one, and
replays the per-shard plans from the registry without a search.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as rck
from repro_torch.core import registry as treg
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed import elastic, stepper
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)},
            "step_scalar": torch.zeros(())}


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    ck.save(d, 7, _tree())
    step, out = ck.restore(d, _tree())
    assert step == 7
    for k in ("a", "step_scalar"):
        assert torch.equal(out[k], _tree()[k])
    assert torch.equal(out["nested"]["b"], _tree()["nested"]["b"])
    assert out["nested"]["b"].dtype == torch.int32


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    ck.save(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_0000000009"))    # a torn write
    assert ck.latest_step(d) == 1


def test_keep_last_gc(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ck.save(d, s, _tree(), keep_last=3)
    assert ck.all_steps(d) == [3, 4, 5]


def test_missing_leaf_raises(tmp_path):
    d = str(tmp_path)
    ck.save(d, 0, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError, match="missing leaves"):
        ck.restore(d, _tree())
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "empty"), _tree())


def test_async_checkpointer(tmp_path):
    d = str(tmp_path)
    c = ck.AsyncCheckpointer(d)
    for s in (10, 20):
        c.save(s, _tree())
    c.wait_pending()
    assert ck.latest_step(d) == 20


def test_restore_with_placement_fn(tmp_path):
    d = str(tmp_path)
    ck.save(d, 3, _tree())
    seen = []
    step, out = ck.restore(d, _tree(), placement_fn=lambda name, leaf:
                           seen.append(name) or CPU)
    assert out["a"].device == CPU
    assert sorted(seen) == ["['a']", "['nested']['b']", "['step_scalar']"]


def test_layout_equals_reference(tmp_path):
    """Same files and the same manifest as the reference's save."""
    tree_r = {"cur": jnp.arange(6.0).reshape(2, 3),
              "list": [jnp.ones((2,)), jnp.zeros((1,), jnp.int32)]}
    tree_t = {"cur": torch.arange(6.0).reshape(2, 3),
              "list": [torch.ones((2,)), torch.zeros((1,),
                                                     dtype=torch.int32)]}
    rck.save(str(tmp_path / "r"), 4, tree_r)
    ck.save(str(tmp_path / "t"), 4, tree_t)
    for side in ("r", "t"):
        assert sorted(os.listdir(tmp_path / side / "step_0000000004")) == \
            ["COMMIT", "arrays.npz", "manifest.json"]
    load = [json.load(open(tmp_path / s / "step_0000000004" /
                           "manifest.json")) for s in ("r", "t")]
    assert load[0] == load[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4, 5)).astype(np.float32)
    tree = {"cur": jnp.asarray(a, dtype), "prev": [jnp.asarray(a * 2,
                                                               dtype)]}
    rck.save(str(tmp_path), 5, tree)
    like = {"cur": torch.zeros(1), "prev": [torch.zeros(1)]}
    step, got = ck.restore(str(tmp_path), like)
    assert step == 5
    for g, w in ((got["cur"], tree["cur"]), (got["prev"][0],
                                             tree["prev"][0])):
        assert str(g.dtype).endswith(dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    a = (torch.randn((3, 4, 5), generator=g) * 4).to(dtype)
    ck.save(str(tmp_path), 6, {"cur": a, "prev": (a + 1,)})
    like = {"cur": jnp.zeros(1), "prev": (jnp.zeros(1),)}
    step, got = rck.restore(str(tmp_path), like)
    assert step == 6
    for r, t in ((got["cur"], a), (got["prev"][0], a + 1)):
        assert str(r.dtype) == str(t.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(r, np.float32),
                                      t.float().numpy())


def test_plan_mesh_and_health_monitor():
    assert elastic.plan_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert elastic.plan_mesh(8) == ((1, 8), ("data", "model"))
    t = [0.0]
    mon = elastic.HealthMonitor(("pod0", "pod1"), timeout_s=10,
                                clock=lambda: t[0])
    assert not mon.degraded
    t[0] = 5.0
    mon.heartbeat("pod0")
    t[0] = 12.0
    assert mon.healthy_slices() == ["pod0"]
    assert mon.degraded


@pytest.fixture
def registry_file(tmp_path, monkeypatch):
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv(treg.ENV_VAR, path)
    return path


@pytest.mark.parametrize("name", ["7pt-const", "25pt-const"])
@pytest.mark.parametrize("plan", [None, "auto"])
def test_elastic_shrink_grow_bitwise(tmp_path, registry_file, name, plan):
    """8 shards -> 2 -> 8, equal to an uninterrupted run and to ops.naive
    bit for bit (the second-order op too)."""
    spec = tst.SPECS[name]
    grid = (8, 16, 16) if spec.radius == 1 else (16, 64, 20)
    state, coeffs = tst.make_problem(spec, grid, seed=9, device="cpu")
    pool = [CPU] * 8
    run = elastic.ElasticStencilRun(spec, state, coeffs,
                                    str(tmp_path / "ck"), t_block=2,
                                    plan=plan, overlap="auto", n_devices=8,
                                    devices=pool)
    run.advance(4)
    run.save()
    assert run.rescale(2).shape == {"data": 1, "model": 2}
    run.advance(2)
    run.save()
    run.rescale(8)
    run.advance(2)
    assert run.steps_done == 8
    whole = stepper.run_distributed(spec, elastic.build_mesh(8, pool), state,
                                    coeffs, 8, 2, plan=plan)
    naive = tops.naive(spec, state, coeffs, 8)
    for a, b, c in zip(run.state, whole, naive):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_rescale_replays_tuned_plans(tmp_path, registry_file, monkeypatch):
    """With both shard keys in the registry a rescale resolves from it
    and never searches (the search is stubbed to fail)."""
    from repro_torch.core import autotune
    spec = tst.SPECS["7pt-const"]
    grid = (8, 16, 16)
    pool = [CPU] * 8
    for n in (8, 2):
        key = stepper.local_extended_shape(spec, elastic.build_mesh(n, pool),
                                           grid, 2)
        treg.default_registry().put(spec, key, MWDPlan(d_w=2, n_f=1), 9.0)

    def no_search(*a, **k):
        raise AssertionError("an elastic rescale searched for a plan")

    monkeypatch.setattr(autotune, "autotune", no_search)
    state, coeffs = tst.make_problem(spec, grid, seed=9, device="cpu")
    run = elastic.ElasticStencilRun(spec, state, coeffs,
                                    str(tmp_path / "ck"), t_block=2,
                                    plan="auto", n_devices=8, devices=pool)
    assert run.plan_source.startswith("registry")
    run.advance(2)
    run.save()
    run.rescale(2)
    assert run.plan_source.startswith("registry")
    assert (run.plan.d_w, run.plan.n_f) == (2, 1)
    run.advance(2)
    want = tops.naive(spec, state, coeffs, 4)
    assert all(torch.equal(a, b) for a, b in zip(run.state, want))


def test_rescale_restore_places_on_the_new_mesh(tmp_path):
    tree = {"cur": torch.arange(8.0)}
    ck.save(str(tmp_path), 2, tree)
    step, state, mesh = elastic.rescale_restore(
        str(tmp_path), tree, lambda m, name, leaf: m.devices.flat[0],
        n_devices=2, devices=[CPU] * 4)
    assert step == 2 and mesh.shape == {"data": 1, "model": 2}
    assert torch.equal(state["cur"], tree["cur"])
