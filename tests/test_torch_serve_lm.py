"""The port's LM serving path (`launch.serve`: `prefill_into_cache`, the
LM half of `main`; `examples.serve_lm`) on the CPU, against the
reference's.

Weights are the reference's `tree_init` carried across
(`params.from_reference`); the reference's serve step runs jitted.
Tolerance: logits within rtol = atol = 1e-3 in float32, as
`test_torch_lm.py::test_decode_matches_forward_and_the_reference`; the
greedy ids equal.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.launch import serve as rserve
from repro.models import lm as rlm
from repro.models import params as rparams
from repro.training import steps as rsteps
from repro_torch import configs as tc
from repro_torch.examples import serve_lm
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim.optimizers import tree_paths
from repro_torch.training import steps as tsteps

ARCHS = ["llama3.2-1b", "gemma3-1b", "mamba2-130m"]


def f32cfg(arch):
    return (dataclasses.replace(rc.reduced(rc.get(arch)), dtype="float32"),
            dataclasses.replace(tc.reduced(tc.get(arch)), dtype="float32"))


def port(tree):
    return tparams.from_reference(jax.tree_util.tree_map(np.asarray, tree),
                                  "cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_prefill_guards_have_the_references_messages():
    cfg_r, cfg_t = f32cfg("llama3.2-1b")
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=0)
    tp = port(p)
    toks = np.zeros((2, 6), np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    for gen, cache_len in ((-1, None), (4, 9), (0, 6), (3, 8)):
        got = message(lambda: tserve.prefill_into_cache(
            cfg_t, tp, tt, gen, cache_len=cache_len))
        want = message(lambda: rserve.prefill_into_cache(
            cfg_r, p, jt, gen, cache_len=cache_len))
        assert got == want
    assert message(lambda: tserve.prefill_into_cache(cfg_t, tp, tt, -2)) \
        == "gen must be >= 0, got -2"
    # the smallest cache that holds the request is accepted (gen=0 reads
    # one slot past the prompt)
    _, cache = tserve.prefill_into_cache(cfg_t, tp, tt, 0, cache_len=7)
    assert tuple(cache["layers"][0]["k"].shape)[1] == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_the_reference(arch):
    """A 20-token prompt (past the reduced local window of 16, so gemma's
    ring wraps) through both packages' prefill_into_cache, then 6 greedy
    steps from the prompt's last token, as `main` runs them."""
    cfg_r, cfg_t = f32cfg(arch)
    p = rparams.tree_init(rlm.param_specs(cfg_r), seed=3)
    tp = port(p)
    gen = 6
    toks = np.random.default_rng(7).integers(
        0, cfg_r.vocab_size, (2, 20)).astype(np.int32)
    lr, cache_r = rserve.prefill_into_cache(cfg_r, p, jnp.asarray(toks), gen)
    lt, cache_t = tserve.prefill_into_cache(cfg_t, tp,
                                            torch.from_numpy(toks), gen)
    assert tuple(lt.shape) == (2, 1, cfg_t.vocab_size)
    np.testing.assert_allclose(f32(lt), f32(lr), rtol=1e-3, atol=1e-3)
    r_serve = jax.jit(rsteps.make_serve_step(cfg_r))
    t_serve = tsteps.make_serve_step(cfg_t)
    r_tok, t_tok = jnp.asarray(toks[:, -1:]), torch.from_numpy(toks[:, -1:])
    for _ in range(gen):
        r_tok, r_lg, cache_r = r_serve(p, cache_r, r_tok)
        t_tok, t_lg, cache_t = t_serve(tp, cache_t, t_tok)
        np.testing.assert_allclose(f32(t_lg), f32(r_lg), rtol=1e-3,
                                   atol=1e-3)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
    lengths = [int(leaf) for name, leaf in tree_paths(cache_t)
               if name.endswith("['length']")]
    assert lengths == [20 + gen] * cfg_t.n_layers


def test_main_serves_an_lm_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--arch", "mamba2-130m", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
    rec = tserve.main(argv)
    out = capsys.readouterr().out
    assert re.search(r"prefill 2x8 in \d+ms; generated 4 tokens/seq at "
                     r"[\d.]+ tok/s \(batch=2\)", out)
    assert f"sample token ids: {rec['ids'][0].tolist()}" in out
    assert tuple(rec["ids"].shape) == (2, 4)
    assert rec["ids"].dtype == torch.int32
    assert len(rec["decode_ms"]) == 4 and rec["tokens_per_s"] > 0
    assert rec["prefill_ms"] > 0 and rec["decode_ms_per_token"] > 0
    assert rec["mesh"] == {"data": 1, "model": 1}
    # the ids are the seed-0 weights' greedy continuation of the seeded
    # prompts, stepped by hand here
    cfg = tc.reduced(tc.get("mamba2-130m"))
    params = tparams.tree_init(tlm.param_specs(cfg), seed=0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    _, cache = tserve.prefill_into_cache(cfg, params, prompts, 4)
    step, tok, ids = tsteps.make_serve_step(cfg), prompts[:, -1:], []
    for _ in range(4):
        tok, _, cache = step(params, cache, tok)
        ids.append(tok)
    assert torch.equal(torch.cat(ids, dim=1), rec["ids"])
    assert torch.equal(tserve.main(argv)["ids"], rec["ids"])


def test_main_refuses_an_encoder_and_defaults_to_the_card(monkeypatch):
    with pytest.raises(SystemExit) as got:
        tserve.main(["--device", "cpu", "--arch", "hubert-xlarge"])
    with pytest.raises(SystemExit) as want:
        rserve.main(["--arch", "hubert-xlarge"])
    assert str(got.value) == str(want.value) \
        == "hubert-xlarge-smoke is encoder-only: no decode"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "mamba2-130m"])
    args = tserve.build_parser().parse_args(["--no-reduced"])
    assert (args.reduced, args.arch, args.stencil, args.device) \
        == (False, "llama3.2-1b", None, "cuda")
    want = rserve.build_parser().parse_args([])
    got = tserve.build_parser().parse_args([])
    for k in ("arch", "reduced", "batch", "prompt_len", "gen", "stencil"):
        assert getattr(got, k) == getattr(want, k), k


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_lm_launchers_hold_one_device_where_several_are_visible(
        launcher, monkeypatch):
    """Both LM launchers build the 1x1 mesh of the device ``--device``
    names, also where the host shows two (here ``cpu`` and ``meta``): a
    mesh over both would split the vocab over 'model', which `place`
    refuses until the sharded LM step."""
    monkeypatch.setattr(tmesh, "local_devices", lambda device=None: [
        torch.device("cpu"), torch.device("meta")])
    if launcher == "serve":
        rec = tserve.main(["--device", "cpu", "--arch", "llama3.2-1b",
                           "--batch", "1", "--prompt-len", "4", "--gen",
                           "2"])
        assert rec["mesh"] == {"data": 1, "model": 1}
        params = rec["params"]
    else:
        params = ttrain.main(["--device", "cpu", "--steps", "1", "--batch",
                              "2", "--seq", "16"])["params"]
    assert {str(p.device) for _, p in tree_paths(params)} == {"cpu"}


def test_the_serve_lm_example_runs_on_the_cpu(capsys):
    rec = serve_lm.main(["--device", "cpu", "--arch", "llama3.2-1b",
                         "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert tuple(rec["ids"].shape) == (2, 3)
    assert int(rec["ids"].max()) < rec["cfg"].vocab_size
    assert "sample token ids:" in capsys.readouterr().out
