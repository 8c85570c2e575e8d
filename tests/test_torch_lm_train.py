"""The port's LM training path (`optim` AdamW/Adafactor, `training.steps`,
`launch.train`) on the CPU, against the reference's on the same inputs.

Weights are the reference's `tree_init` carried across (`from_reference`);
the reference's steps run jitted on the CPU. Tolerances: optimizer updates
and state within 1e-6 relative on identical gradients; a train step's
metrics within 1e-4 x max(1, |ref|) in float32, and the loss one update
later as well (an update's elementwise sign can flip where a gradient is
at round-off level, which moves no loss); bfloat16 losses within 2e-2
relative. The launcher's resume is held bitwise against a straight run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.data import pipeline as rpipe
from repro.distributed import checkpoint as rckpt
from repro.models import lm as rlm
from repro.models import params as rparams
from repro.optim import optimizers as ropt
from repro.training import steps as rsteps
from repro_torch import configs as tc
from repro_torch.distributed import checkpoint
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import params as tparams
from repro_torch.optim import optimizers as topt
from repro_torch.training import steps as tsteps

ARCHS = list(rc.ARCH_IDS)


def port(tree):
    return tparams.from_reference(jax.tree_util.tree_map(np.asarray, tree),
                                  "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    got, want = float(got), float(want)
    return abs(got - want) <= tol * max(1.0, abs(want))


def lm_batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        # distinct rows per sample so a wrong microbatch slice shows
        out["positions"] = (np.arange(s, dtype=np.int32)[None, None]
                            + np.arange(b, dtype=np.int32)[None, :, None]
                            + np.zeros((3, 1, 1), np.int32))
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def opt_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "e": rng.standard_normal((3, 4, 5)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32)]}


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_updates_match_the_reference(kind):
    ropt_ = ropt.make_optimizer(kind)
    topt_ = topt.make_optimizer(kind)
    p_np = opt_tree()
    rp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = tparams.from_reference(p_np, "cpu")
    rs, ts = ropt_.init(rp), topt_.init(tp)
    for step in range(4):
        g_np = opt_tree(seed=10 + step)
        ru, rs = ropt_.update(jax.tree_util.tree_map(jnp.asarray, g_np), rs,
                              rp, jnp.asarray(step, jnp.int32))
        tu, ts = topt_.update(tparams.from_reference(g_np, "cpu"), ts, tp,
                              torch.tensor(step, dtype=torch.int32))
        for got, want in ((tu, ru), (ts, rs)):
            # JAX flattens dicts in sorted key order; compare by path
            g_l, w_l = tparams.sorted_leaves(got), jax.tree_util.tree_leaves(
                want)
            assert len(g_l) == len(w_l)
            for g, w in zip(g_l, w_l):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    f32(g), w, rtol=1e-6,
                    atol=1e-6 * max(float(np.abs(w).max()), 1e-30))
        rp = ropt.apply_updates(rp, ru)
        tp = topt.apply_updates(tp, tu)


def test_adafactor_state_is_factored():
    p = tparams.from_reference(opt_tree(), "cpu")
    s = topt.adafactor().init(p)
    assert set(s["w"]) == {"vr", "vc"}
    assert tuple(s["w"]["vr"].shape) == (6,)
    assert tuple(s["w"]["vc"].shape) == (5,)
    assert tuple(s["e"]["vr"].shape) == (3, 4)
    assert tuple(s["e"]["vc"].shape) == (3, 5)
    assert set(s["b"][0]) == {"v"} and tuple(s["b"][0]["v"].shape) == (7,)
    want = ropt.adafactor().init(jax.tree_util.tree_map(jnp.asarray,
                                                        opt_tree()))
    assert [tuple(x.shape) for x in tparams.sorted_leaves(s)] == [
        x.shape for x in jax.tree_util.tree_leaves(want)]


def test_make_optimizer_defaults_and_refusal():
    p_np = {"w": np.ones((2, 3), np.float32)}
    g_np = {"w": np.full((2, 3), 0.5, np.float32)}
    for kind, lr in (("adamw", 3e-4), ("adafactor", 1e-2)):
        u, _ = topt.make_optimizer(kind).update(
            tparams.from_reference(g_np, "cpu"),
            topt.make_optimizer(kind).init(
                tparams.from_reference(p_np, "cpu")),
            tparams.from_reference(p_np, "cpu"), 0)
        u2, _ = getattr(topt, kind)(lr=lr).update(
            tparams.from_reference(g_np, "cpu"),
            getattr(topt, kind)(lr=lr).init(
                tparams.from_reference(p_np, "cpu")),
            tparams.from_reference(p_np, "cpu"), 0)
        assert torch.equal(u["w"], u2["w"])
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd")


# ---------------------------------------------------------------------------
# train, serve and prefill steps
# ---------------------------------------------------------------------------

def both_states(cfg_r, opt_t, seed=1):
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=seed)
    r_state = {"params": p,
               "opt": rsteps.make_optimizer(cfg_r.optimizer).init(p),
               "step": jnp.zeros((), jnp.int32)}
    tp = port(p)
    t_state = {"params": tp, "opt": opt_t.init(tp),
               "step": torch.zeros((), dtype=torch.int32)}
    return r_state, t_state


def run_both(cfg_r, cfg_t, nb, n_steps=2, **kw):
    """`n_steps` train steps of both packages from the same weights on the
    same batch: the per-step metrics, each ``(port, reference)``."""
    _, r_train = rsteps.make_train_step(cfg_r, **kw)
    opt_t, t_train = tsteps.make_train_step(cfg_t, **kw)
    r_state, t_state = both_states(cfg_r, opt_t)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    j_train = jax.jit(r_train)
    out = []
    for _ in range(n_steps):
        r_state, r_m = j_train(r_state, jb)
        t_state, t_m = t_train(t_state, tb)
        out.append((t_m, r_m))
    assert int(t_state["step"]) == n_steps
    return out


def f32cfg(arch, **kw):
    return (dataclasses.replace(rc.reduced(rc.get(arch), **kw),
                                dtype="float32"),
            dataclasses.replace(tc.reduced(tc.get(arch), **kw),
                                dtype="float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference_f32(arch):
    cfg_r, cfg_t = f32cfg(arch)
    (m0, r0), (m1, r1) = run_both(cfg_r, cfg_t, lm_batch(cfg_r), chunk=16)
    assert set(m0) == {"ce", "aux", "loss", "grad_norm"} == set(r0)
    for k in m0:
        assert close(m0[k], r0[k], 1e-4), (k, float(m0[k]), float(r0[k]))
    assert np.isfinite(float(m1["loss"]))
    assert close(m1["loss"], r1["loss"], 1e-4), (float(m1["loss"]),
                                                 float(r1["loss"]))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-vl-2b",
                                  "mixtral-8x7b"])
def test_accumulated_train_step_matches_the_reference(arch):
    cfg_r, cfg_t = f32cfg(arch)
    nb = lm_batch(cfg_r, b=4, s=16, seed=3)
    (m0, r0), (m1, r1) = run_both(cfg_r, cfg_t, nb, chunk=8, accum=2)
    for k in m0:
        assert close(m0[k], r0[k], 1e-4), (k, float(m0[k]), float(r0[k]))
    assert close(m1["loss"], r1["loss"], 1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b"])
def test_bf16_train_step_matches_the_reference(arch):
    cfg_r, cfg_t = rc.reduced(rc.get(arch)), tc.reduced(tc.get(arch))
    (m0, r0), (m1, r1) = run_both(cfg_r, cfg_t, lm_batch(cfg_r, seed=5),
                                  chunk=16)
    for m, r in ((m0, r0), (m1, r1)):
        assert abs(float(m["loss"]) - float(r["loss"])) \
            <= 2e-2 * abs(float(r["loss"]))


def test_serve_and_prefill_steps_match_the_reference():
    cfg_r, cfg_t = f32cfg("gemma3-1b")
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=2)
    tp = port(p)
    toks = np.random.default_rng(6).integers(
        0, cfg_r.vocab_size, (2, 20)).astype(np.int32)
    want = rsteps.make_prefill_step(cfg_r, chunk=8)(
        p, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(cfg_t, chunk=8)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert not got.requires_grad
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    assert float(np.abs(f32(got) - np.asarray(want)).max()) <= 1e-4 * scale

    r_serve = jax.jit(rsteps.make_serve_step(cfg_r))
    t_serve = tsteps.make_serve_step(cfg_t)
    r_cache = rlm.init_cache(cfg_r, 2, 20)
    from repro_torch.models import lm as tlm
    t_cache = tlm.init_cache(cfg_t, 2, 20, device="cpu")
    r_tok, t_tok = jnp.asarray(toks[:, :1]), torch.from_numpy(toks[:, :1])
    for _ in range(6):
        r_tok, r_lg, r_cache = r_serve(p, r_cache, r_tok)
        t_tok, t_lg, t_cache = t_serve(tp, t_cache, t_tok)
        assert t_tok.dtype == torch.int32 and tuple(t_tok.shape) == (2, 1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
        np.testing.assert_allclose(f32(t_lg), np.asarray(r_lg), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def launch_args(ckpt, steps, *extra):
    return ["--device", "cpu", "--batch", "2", "--seq", "32",
            "--steps", str(steps), "--ckpt", str(ckpt), "--ckpt-every", "3",
            *extra]


def test_launcher_resume_is_bitwise(tmp_path):
    straight = ttrain.main(launch_args(tmp_path / "a", 6))
    ttrain.main(launch_args(tmp_path / "b", 3))
    assert checkpoint.all_steps(tmp_path / "b") == [3]
    resumed = ttrain.main(launch_args(tmp_path / "b", 6))
    assert checkpoint.all_steps(tmp_path / "b") == [3, 6]
    assert checkpoint.all_steps(tmp_path / "a") == [3, 6]
    a, b = topt.tree_leaves(straight), topt.tree_leaves(resumed)
    assert len(a) == len(b) and int(resumed["step"]) == 6
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_launcher_losses_match_the_reference_steps(tmp_path):
    """The launcher's first two losses (reduced llama, bf16, seed 0, lr
    3e-3, the synthetic pipeline) against the reference's train step on
    the reference's pipeline batches."""
    records = []
    ttrain.main(launch_args(tmp_path / "c", 2, "--accum", "2"),
                records=records)
    assert [r["step"] for r in records] == [0, 1]
    cfg = rc.reduced(rc.get("llama3.2-1b"))
    _, r_train = rsteps.make_train_step(cfg, lr=3e-3, chunk=32, accum=2)
    p = rparams.tree_init(rlm.param_specs(cfg), seed=0)
    state = {"params": p, "opt": rsteps.make_optimizer("adamw", 3e-3).init(p),
             "step": jnp.zeros((), jnp.int32)}
    pipe = rpipe.SyntheticPipeline(rpipe.PipelineConfig(2, 32,
                                                        cfg.vocab_size))
    j_train = jax.jit(r_train)
    for step, rec in enumerate(records):
        state, m = j_train(state, pipe.get_batch(step, cfg))
        assert abs(rec["loss"] - float(m["loss"])) \
            <= 2e-2 * abs(float(m["loss"]))
        assert rec["ms"] > 0


def test_launcher_runs_every_family_on_the_cpu(tmp_path):
    for arch in ("mamba2-130m", "jamba-1.5-large-398b", "hubert-xlarge"):
        records = []
        state = ttrain.main(["--device", "cpu", "--arch", arch, "--steps",
                             "2", "--batch", "2", "--seq", "16"],
                            records=records)
        assert int(state["step"]) == 2
        assert all(np.isfinite(r["loss"]) for r in records)


def test_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--steps", "1"])


def test_step_guard_flags_stragglers():
    guard = ttrain.StepGuard(factor=3.0)
    assert not any(guard.observe(0.1) for _ in range(5))
    assert guard.observe(0.5)
    assert not guard.observe(0.2)
    assert guard.stragglers == 1


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b"])
def test_launcher_restores_a_reference_train_state(arch, tmp_path):
    """A train state the reference checkpointed (AdamW, or Adafactor's
    factored moments) restores through the launcher's skeleton bit for
    bit, on the port's structure."""
    cfg_r, cfg_t = rc.reduced(rc.get(arch)), tc.reduced(tc.get(arch))
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=4)
    opt_r = rsteps.make_optimizer(cfg_r.optimizer)
    state = {"params": p, "opt": opt_r.init(p),
             "step": jnp.asarray(7, jnp.int32)}
    g = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 0.01, p)
    _, state["opt"] = opt_r.update(g, state["opt"], p, 0)
    rckpt.save(str(tmp_path), 7, state)
    mesh = make_debug_mesh((1, 1), devices=["cpu"])
    step, got = ttrain.restore_state(str(tmp_path), cfg_t,
                                     topt.make_optimizer(cfg_t.optimizer),
                                     mesh)
    assert step == 7 and int(got["step"]) == 7
    want = jax.tree_util.tree_leaves(state)
    have = tparams.sorted_leaves(got)
    assert len(have) == len(want)
    for a, b in zip(have, want):
        b = np.asarray(b)
        if b.dtype.name == "bfloat16":
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)
