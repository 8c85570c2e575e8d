"""The port's LM substrate models (`repro_torch.configs`, `models.*`,
`data.pipeline`) on the CPU, against the reference's on the same inputs.

Inputs come from numpy seeds; weights are the reference's `tree_init`
carried across with `from_reference` (and the port's own `tree_init` is
held bitwise against it). Tolerances: float32 logits and losses within
1e-4 x max(1, max|ref|), gradients within 1e-4 of the largest gradient,
bfloat16 losses within 2e-2 relative, layer outputs within the reference's
own tests' tolerances. No Pallas kernel lies on this path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.configs import base as rbase
from repro.data import pipeline as rpipe
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import mamba as RM
from repro.models import moe as RMOE
from repro.models import params as rparams
from repro_torch import configs as tc
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import params as tparams
from repro_torch.optim.optimizers import tree_leaves, tree_paths

ARCHS = list(rc.ARCH_IDS)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(tree):
    """Reference arrays (or numpy) as CPU tensors, bit for bit."""
    return tparams.from_reference(to_np(tree), "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    """|got - want| <= tol * max(1, max|want|), elementwise."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def bits(x) -> np.ndarray:
    a = x.detach().contiguous()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy()
    return a.numpy().view(np.uint8)


def ref_bits(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.view(np.uint8)


def f32cfg(arch, **kw):
    """The reduced config of `arch` in float32, both packages'."""
    return (dataclasses.replace(rc.reduced(rc.get(arch), **kw),
                                dtype="float32"),
            dataclasses.replace(tc.reduced(tc.get(arch), **kw),
                                dtype="float32"))


def lm_batch(cfg, b=2, s=32, seed=0):
    """numpy batch of the reference's test_lm_archs, in float32 embeds."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "none":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    if cfg.mrope_sections:
        out["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32), (3, b, s)).copy()
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_references(arch):
    r, t = rc.get(arch), tc.get(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert (dataclasses.asdict(tc.reduced(t))
            == dataclasses.asdict(rc.reduced(r)))
    kw = dict(n_layers=8, d_model=32, vocab=64)
    assert (dataclasses.asdict(tc.reduced(t, **kw))
            == dataclasses.asdict(rc.reduced(r, **kw)))
    for c_t, c_r in ((t, r), (tc.reduced(t), rc.reduced(r))):
        for prop in ("resolved_head_dim", "pattern_period", "d_inner",
                     "ssm_heads", "attention_free", "max_kv_seq_bounded",
                     "supports_long_context", "supports_decode"):
            assert getattr(c_t, prop) == getattr(c_r, prop), prop
        assert ([c_t.layer_kind(i) for i in range(c_t.n_layers)]
                == [c_r.layer_kind(i) for i in range(c_r.n_layers)])
        assert ([c_t.is_moe_layer(i) for i in range(c_t.n_layers)]
                == [c_r.is_moe_layer(i) for i in range(c_r.n_layers)])
        for shape in rbase.SHAPES:
            assert (tbase.shape_applicable(c_t, shape)
                    == rbase.shape_applicable(c_r, shape))


def test_registry_and_shapes_equal_the_references():
    assert tc.ARCH_IDS == rc.ARCH_IDS
    assert tbase.SHAPES == rbase.SHAPES
    with pytest.raises(KeyError):
        tc.get("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_counts_equal_the_references(arch):
    cfg_r, cfg_t = rc.get(arch), tc.get(arch)
    for stacked in (False, True):
        assert (tparams.count_params(tlm.param_specs(cfg_t, stacked=stacked))
                == rparams.count_params(rlm.param_specs(cfg_r,
                                                        stacked=stacked)))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("stacked", [False, True])
def test_tree_init_is_the_references_bitwise(arch, stacked):
    cfg_r, cfg_t = rc.reduced(rc.get(arch)), tc.reduced(tc.get(arch))
    want = rparams.tree_init(rlm.param_specs(cfg_r, stacked=stacked), seed=7)
    got = tparams.tree_init(tlm.param_specs(cfg_t, stacked=stacked), seed=7,
                            device="cpu")
    w_paths = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_leaves_with_path(want)]
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = tree_leaves(got)
    assert len(g_leaves) == len(w_leaves)
    assert [n for n, _ in tree_paths(got)] == w_paths
    for g, w in zip(g_leaves, w_leaves):
        assert g.dtype == getattr(torch, str(w.dtype))
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(bits(g), ref_bits(w))


def test_from_reference_and_abstract_tree():
    cfg_r, cfg_t = rc.reduced(rc.get("gemma3-1b")), tc.reduced(
        tc.get("gemma3-1b"))
    want = rparams.tree_init(rlm.param_specs(cfg_r), seed=3)
    got = port(want)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(bits(g), ref_bits(w))
    meta = tparams.tree_abstract(tlm.param_specs(cfg_t))
    assert [(m.shape, m.dtype, m.device.type) for m in tree_leaves(meta)] \
        == [(g.shape, g.dtype, "meta") for g in tree_leaves(got)]


@pytest.mark.parametrize("builder", ["tree_init", "from_reference",
                                     "init_cache", "get_batch"])
def test_builders_default_to_the_card(builder):
    """No fallback: without a device named, each builder places its tensors
    on the card, and raises where there is none."""
    cfg = tc.reduced(tc.get("llama3.2-1b"))
    pipe = tpipe.SyntheticPipeline(tpipe.PipelineConfig(2, 8, 64))
    build = {
        "tree_init": lambda: tparams.tree_init(tlm.param_specs(cfg)),
        "from_reference": lambda: tparams.from_reference(
            {"w": np.ones((2, 3), np.float32)}),
        "init_cache": lambda: tlm.init_cache(cfg, 1, 8),
        "get_batch": lambda: pipe.get_batch(0, cfg),
    }[builder]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        return
    assert {t.device.type for t in tree_leaves(build())} == {"cuda"}


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [None, "qwen2-vl-2b", "hubert-xlarge"])
def test_pipeline_batches_are_the_references_bitwise(arch):
    rcfg = rc.reduced(rc.get(arch)) if arch else None
    tcfg = tc.reduced(tc.get(arch)) if arch else None
    vocab = rcfg.vocab_size if rcfg else 1000
    r = rpipe.SyntheticPipeline(rpipe.PipelineConfig(3, 16, vocab, seed=9))
    t = tpipe.SyntheticPipeline(tpipe.PipelineConfig(3, 16, vocab, seed=9))
    for step in range(4):
        want = r.get_batch(step, rcfg)
        got = t.get_batch(step, tcfg, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            np.testing.assert_array_equal(bits(got[k]), ref_bits(want[k]))
    assert t.state(5) == r.state(5)


# ---------------------------------------------------------------------------
# layers (tests/test_layers.py cases)
# ---------------------------------------------------------------------------

ATTN_CASES = [(kind, window, chunk, causal)
              for kind, window in (("global", 0), ("local", 5))
              for chunk in (4, 16, 64) for causal in (True, False)
              if causal or kind == "global"]


@pytest.mark.parametrize("kind,window,chunk,causal", ATTN_CASES)
def test_attention_core_matches_the_reference(kind, window, chunk, causal):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    want = RL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kind=kind, window=window, causal=causal,
                             chunk=chunk)
    got = TL.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), kind=kind, window=window,
                            causal=causal, chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_attention_core_with_an_offset_in_bf16():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 20, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, 20, 1, 16)).astype(np.float32)
    kw = dict(kind="local", window=6, causal=True, q_offset=12, chunk=4)
    want = RL.attention_core(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), **kw)
    got = TL.attention_core(*(torch.from_numpy(a).bfloat16()
                              for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("sections", [(), (2, 3, 3)])
def test_rope_matches_the_reference(sections):
    rng = np.random.default_rng(1)
    if sections:
        pos = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
    else:
        pos = rng.integers(0, 50, (2, 6)).astype(np.int32)
    cw, sw = RL.rope_angles(jnp.asarray(pos), 16, 1e4, sections)
    cg, sg = TL.rope_angles(torch.from_numpy(pos), 16, 1e4, sections)
    np.testing.assert_allclose(f32(cg), f32(cw), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(sg), f32(sw), rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    want = RL.apply_rope(jnp.asarray(x), cw, sw)
    got = TL.apply_rope(torch.from_numpy(x), cg, sg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    # the relative property holds in the port as in the reference
    if not sections:
        q = torch.from_numpy(x[:1, :1, :1])
        dots = []
        for off in (0, 3):
            cq, sq = TL.rope_angles(torch.tensor([[off]]), 16, 1e4)
            ck, sk = TL.rope_angles(torch.tensor([[off + 2]]), 16, 1e4)
            dots.append(float(torch.sum(TL.apply_rope(q, cq, sq)
                                        * TL.apply_rope(q, ck, sk))))
        assert abs(dots[0] - dots[1]) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_the_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((8,)).astype(np.float32)
    want = RL.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    got = TL.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(w), 1e-6)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu2"])
def test_mlp_matches_the_reference(act):
    cfg = dataclasses.replace(rc.reduced(rc.get("llama3.2-1b")), act=act)
    p = rparams.tree_init(RL.mlp_specs(cfg, "float32"), seed=4)
    x = np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    want = RL.mlp(p, jnp.asarray(x), act)
    got = TL.mlp(port(p), torch.from_numpy(x), act)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-vl-2b"])
def test_attention_block_matches_the_reference(arch):
    cfg_r, cfg_t = f32cfg(arch)
    p = rparams.tree_init(RL.attention_specs(cfg_r, "float32"), seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 24, cfg_r.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    if cfg_r.mrope_sections:
        pos = np.broadcast_to(pos, (3, 2, 24))
    pos = np.ascontiguousarray(pos)
    for kind in ("global", "local"):
        want, _ = RL.attention(p, cfg_r, jnp.asarray(x), jnp.asarray(pos),
                               kind, chunk=8,
                               sections=cfg_r.mrope_sections)
        got, _ = TL.attention(port(p), cfg_t, torch.from_numpy(x),
                              torch.from_numpy(pos), kind, chunk=8,
                              sections=cfg_t.mrope_sections)
        assert_close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# MoE (tests/test_moe.py cases)
# ---------------------------------------------------------------------------

def moe_cfg(e=4, k=2, d=16, f=32, **kw):
    args = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
                n_kv_heads=1, d_ff=f, vocab_size=64, n_experts=e,
                experts_per_token=k, **kw)
    return rbase.ArchConfig(**args), tbase.ArchConfig(**args)


@pytest.mark.parametrize("e,k,act,cf", [(4, 2, "silu", 1.25),
                                        (8, 2, "gelu", 1.25),
                                        (2, 1, "silu", 1e-6),
                                        (4, 1, "silu", 0.5)])
def test_moe_matches_the_reference(e, k, act, cf):
    cfg_r, cfg_t = moe_cfg(e=e, k=k, capacity_factor=cf)
    p = rparams.tree_init(RMOE.moe_specs(cfg_r, "float32"), seed=1)
    x = np.random.default_rng(1).standard_normal((2, 32, 16)).astype(
        np.float32)
    want, aux_w = RMOE.moe_ffn(p, cfg_r, jnp.asarray(x), act)
    got, aux_g = TMOE.moe_ffn(port(p), cfg_t, torch.from_numpy(x), act)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_g), float(aux_w), rtol=1e-6)
    for t in (1, 7, 64, 100):
        assert TMOE.capacity(cfg_t, t) == RMOE.capacity(cfg_r, t)


def test_moe_dropped_tokens_get_no_output():
    """capacity_factor ~0: 8 slots an expert, the rest dropped (zeros), as
    the reference's test_dropped_tokens_get_partial_output."""
    cfg_r, cfg_t = moe_cfg(e=2, k=1, capacity_factor=1e-6)
    p = rparams.tree_init(RMOE.moe_specs(cfg_r, "float32"), seed=1)
    x = np.random.default_rng(1).standard_normal((1, 64, 16)).astype(
        np.float32)
    got, _ = TMOE.moe_ffn(port(p), cfg_t, torch.from_numpy(x), "silu")
    want, _ = RMOE.moe_ffn(p, cfg_r, jnp.asarray(x), "silu")
    routed_g = (np.abs(f32(got)[0]) > 0).any(axis=-1)
    routed_w = (np.abs(f32(want)[0]) > 0).any(axis=-1)
    assert int(routed_g.sum()) <= 16
    np.testing.assert_array_equal(routed_g, routed_w)


def test_moe_gradients_match_the_reference():
    cfg_r, cfg_t = moe_cfg(e=4, k=2, capacity_factor=0.75)
    p = rparams.tree_init(RMOE.moe_specs(cfg_r, "float32"), seed=2)
    x = np.random.default_rng(2).standard_normal((2, 16, 16)).astype(
        np.float32)

    def rloss(p):
        y, aux = RMOE.moe_ffn(p, cfg_r, jnp.asarray(x), "silu")
        return jnp.sum(y * y) + aux

    gw = jax.grad(rloss)(p)
    tp = port(p)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    y, aux = TMOE.moe_ffn(leaves, cfg_t, torch.from_numpy(x), "silu")
    (torch.sum(y * y) + aux).backward()
    scale = max(float(np.abs(np.asarray(g)).max()) for g in gw.values())
    for name in gw:
        err = float(np.abs(f32(leaves[name].grad) - np.asarray(gw[name])).max())
        assert err <= 1e-4 * scale, (name, err, scale)


# ---------------------------------------------------------------------------
# Mamba2 (tests/test_mamba.py cases)
# ---------------------------------------------------------------------------

def ssd_recurrence(xh, dt, a, bmat, cmat):
    """Literal SSD recurrence: s_t = exp(dt_t a) s_{t-1} + dt_t B_t (x) x_t."""
    b, l, h, p = xh.shape
    s = np.zeros((b, h, bmat.shape[-1], p))
    ys = []
    for t in range(l):
        dec = np.exp(dt[:, t] * a)
        outer = np.einsum("bn,bhp->bhnp", bmat[:, t],
                          xh[:, t] * dt[:, t][..., None])
        s = dec[..., None, None] * s + outer
        ys.append(np.einsum("bn,bhnp->bhp", cmat[:, t], s))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_the_recurrence_and_reference(chunk):
    rng = np.random.default_rng(0)
    b, l, h, p, n = 2, 16, 3, 4, 5
    xh = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, (b, l, h)).astype(np.float32)
    a = (-rng.uniform(0.1, 1.0, (h,))).astype(np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    got = TM.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)), chunk)
    np.testing.assert_allclose(f32(got), ssd_recurrence(xh, dt, a, bm, cm),
                               rtol=2e-4, atol=2e-4)
    want = RM.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), chunk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError):
        TM.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)), 6)


def test_mamba_block_and_decode_match_the_reference():
    cfg_r = rc.reduced(rc.get("mamba2-130m"), d_model=32)
    cfg_t = tc.reduced(tc.get("mamba2-130m"), d_model=32)
    pp = rparams.tree_init(RM.mamba_specs(cfg_r, "float32"), seed=1)
    tp = port(pp)
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg_r.d_model)).astype(np.float32)
    want, _ = RM.mamba_block(pp, cfg_r, jnp.asarray(x), chunk=4)
    got, _ = TM.mamba_block(tp, cfg_t, torch.from_numpy(x), chunk=4)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    cache = {"conv": torch.zeros((2, cfg_t.ssm_conv - 1,
                                  cfg_t.d_inner + 2 * cfg_t.ssm_state)),
             "ssm": torch.zeros((2, cfg_t.ssm_heads, cfg_t.ssm_state,
                                 cfg_t.ssm_head_dim)),
             "length": torch.zeros((), dtype=torch.int32)}
    ys = []
    for t in range(8):
        y, cache = TM.mamba_block(tp, cfg_t, torch.from_numpy(x[:, t:t + 1]),
                                  cache=cache)
        ys.append(y)
    assert int(cache["length"]) == 8
    np.testing.assert_allclose(f32(torch.cat(ys, 1)), f32(got), rtol=5e-3,
                               atol=5e-3)


def test_causal_conv_state_is_consistent():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    b = torch.zeros(6)
    full, _ = TM._causal_conv(x, w, b)
    want, _ = RM._causal_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                              jnp.zeros(6))
    np.testing.assert_allclose(f32(full), f32(want), rtol=1e-5, atol=1e-5)
    state, outs = torch.zeros((1, 3, 6)), []
    for t in range(10):
        o, state = TM._causal_conv(x[:, t:t + 1], w, b, state)
        outs.append(o)
    np.testing.assert_allclose(f32(torch.cat(outs, 1)), f32(full),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model, every architecture (tests/test_lm_archs.py cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_f32():
    """Per arch: the reference's float32 params, batch, logits, loss,
    metrics and step-0 gradients (jitted; computed once)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r, _ = f32cfg(arch)
            p = rparams.tree_init(rlm.param_specs(cfg_r), seed=1)
            nb = lm_batch(cfg_r)
            jb = {k: jnp.asarray(v) for k, v in nb.items()}
            logits, aux = jax.jit(
                lambda p: rlm.forward(cfg_r, p, jb, chunk=16))(p)
            (loss, mt), g = jax.jit(jax.value_and_grad(
                lambda p: rlm.loss_fn(cfg_r, p, jb, chunk=16),
                has_aux=True))(p)
            cache[arch] = dict(params=p, batch=nb, logits=logits, aux=aux,
                               loss=loss, metrics=mt, grads=g)
        return cache[arch]
    return get


def tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference_f32(arch, reference_f32):
    ref = reference_f32(arch)
    _, cfg_t = f32cfg(arch)
    tp = port(ref["params"])
    logits, aux = tlm.forward(cfg_t, tp, tbatch(ref["batch"]), chunk=16)
    assert logits.shape == (2, 32, cfg_t.vocab_size)
    assert torch.isfinite(logits).all()
    assert_close(logits, ref["logits"], 1e-4)
    assert_close(aux, ref["aux"], 1e-4)
    loss, mt = tlm.loss_fn(cfg_t, tp, tbatch(ref["batch"]), chunk=16)
    assert_close(loss, ref["loss"], 1e-4)
    for k in ("ce", "aux"):
        assert_close(mt[k], ref["metrics"][k], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_gradients_match_the_reference_f32(arch, reference_f32):
    ref = reference_f32(arch)
    _, cfg_t = f32cfg(arch)
    tp = port(ref["params"])
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss, _ = tlm.loss_fn(cfg_t, tp, tbatch(ref["batch"]), chunk=16)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    want = jax.tree_util.tree_leaves(ref["grads"])
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        err = float(np.abs(f32(g) - np.asarray(w)).max())
        assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_the_reference(arch):
    cfg_r, cfg_t = rc.reduced(rc.get(arch)), tc.reduced(tc.get(arch))
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=1)
    nb = lm_batch(cfg_r, seed=2)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    want, _ = jax.jit(lambda p: rlm.loss_fn(cfg_r, p, jb, chunk=16))(p)
    got, _ = tlm.loss_fn(cfg_t, port(p), tbatch(nb), chunk=16)
    assert abs(float(got) - float(want)) <= 2e-2 * abs(float(want))


def copy_into_stacked(cfg, unrolled, stacked):
    """The unrolled weights in the stacked layout (test_lm_archs' copy)."""
    period = cfg.pattern_period
    n_rep = cfg.n_layers // period

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    out = dict(stacked)
    out["blocks_stacked"] = [
        stack(*(unrolled["blocks"][r * period + j] for r in range(n_rep)))
        for j in range(period)]
    out["blocks_tail"] = [unrolled["blocks"][n_rep * period + j]
                          for j in range(cfg.n_layers - n_rep * period)]
    for k in ("embed", "final_norm", "head"):
        if k in unrolled:
            out[k] = unrolled[k]
    return out


@pytest.mark.parametrize("arch", ["gemma3-1b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "mamba2-130m"])
def test_stacked_equals_unrolled(arch):
    cfg_r, cfg_t = f32cfg(arch, n_layers=8)
    p_r = rparams.tree_init(rlm.param_specs(cfg_r), seed=3)
    p_un = port(p_r)
    p_st = copy_into_stacked(cfg_t, p_un, tparams.tree_init(
        tlm.param_specs(cfg_t, stacked=True), seed=99, device="cpu"))
    nb = lm_batch(cfg_t)
    l1, a1 = tlm.forward(cfg_t, p_un, tbatch(nb), chunk=16)
    l2, a2 = tlm.forward(cfg_t, p_st, tbatch(nb), chunk=16)
    np.testing.assert_allclose(f32(l2), f32(l1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(a2), float(a1), rtol=1e-4, atol=1e-4)
    want, _ = rlm.forward(cfg_r, p_r, {k: jnp.asarray(v)
                                       for k, v in nb.items()}, chunk=16)
    assert_close(l2, want, 1e-4)
    # the stacked cache decodes as the unrolled one does
    toks = torch.from_numpy(nb["tokens"][:1, :3]) if "tokens" in nb else None
    if toks is not None and cfg_t.supports_decode:
        c_un = tlm.init_cache(cfg_t, 1, 8, device="cpu")
        c_st = tlm.init_cache(cfg_t, 1, 8, stacked=True, device="cpu")
        for t in range(3):
            g1, c_un = tlm.decode_step(cfg_t, p_un, c_un, toks[:, t:t + 1])
            g2, c_st = tlm.decode_step(cfg_t, p_st, c_st, toks[:, t:t + 1])
            np.testing.assert_allclose(f32(g2), f32(g1), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-1b", "mamba2-130m",
                                  "mixtral-8x7b"])
def test_decode_matches_forward_and_the_reference(arch):
    """Token-by-token decode reproduces the forward logits (KV ring buffers
    with wrap-around, rope offsets, SSM state carry), with the reference's
    no-drop MoE capacity; and equals the reference's decode."""
    cfg_r, cfg_t = f32cfg(arch, n_layers=4)
    cfg_r = dataclasses.replace(cfg_r, capacity_factor=8.0)
    cfg_t = dataclasses.replace(cfg_t, capacity_factor=8.0)
    p_r = rparams.tree_init(rlm.param_specs(cfg_r), seed=5)
    tp = port(p_r)
    s = 24   # > reduced window (16): exercises the local-attention ring wrap
    toks = np.random.default_rng(4).integers(
        0, cfg_t.vocab_size, (1, s)).astype(np.int32)
    want, _ = tlm.forward(cfg_t, tp, {"tokens": torch.from_numpy(toks)},
                          chunk=8)
    cache = tlm.init_cache(cfg_t, 1, s, device="cpu")
    cache_r = rlm.init_cache(cfg_r, 1, s)
    step_r = jax.jit(lambda c, t: rlm.decode_step(cfg_r, p_r, c, t))
    got, got_r = [], []
    for t in range(s):
        lg, cache = tlm.decode_step(cfg_t, tp, cache,
                                    torch.from_numpy(toks[:, t:t + 1]))
        lr, cache_r = step_r(cache_r, jnp.asarray(toks[:, t:t + 1]))
        got.append(lg)
        got_r.append(lr)
    got = torch.cat(got, dim=1)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-3, atol=1e-3)
    assert_close(got, jnp.concatenate(got_r, axis=1), 1e-4)
    lengths = [int(c["length"]) for c in cache["layers"]]
    assert lengths == [s] * cfg_t.n_layers


def test_cache_spec_matches_the_reference():
    for arch in ("gemma3-1b", "jamba-1.5-large-398b"):
        cfg_r, cfg_t = rc.reduced(rc.get(arch)), tc.reduced(tc.get(arch))
        for stacked in (False, True):
            want = jax.tree_util.tree_leaves(
                rlm.cache_spec(cfg_r, 2, 40, stacked=stacked))
            got = tparams.sorted_leaves(
                tlm.cache_spec(cfg_t, 2, 40, stacked=stacked))
            assert [(tuple(s.shape), str(s.dtype).replace("torch.", ""))
                    for s in got] == [(s.shape, str(s.dtype)) for s in want]
            cache = tlm.init_cache(cfg_t, 2, 40, length=3, stacked=stacked,
                                   device="cpu")
            ref = rlm.init_cache(cfg_r, 2, 40, length=3, stacked=stacked)
            for g, w in zip(tparams.sorted_leaves(cache),
                            jax.tree_util.tree_leaves(ref)):
                np.testing.assert_array_equal(f32(g), f32(w))
