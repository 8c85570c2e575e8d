"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: every fault a cell can have reads
``correct`` false, as does the control put in the program's place."""

import pytest
import torch

from girih_bench import harness
from girih_bench.reference import stencils as ref

SOLVE = {"config": {"grid": [12, 14, 16]}}
SERVE = {"traffic": {"axes": [10, 12, 14, 16], "tenants": 4,
                     "rate_per_s": 12.0, "sample": 4, "warm_s": 0.2}}
CELLS = [("solve-7pt-var-512", SOLVE), ("solve-25pt-const-512", SOLVE),
         ("serve-7pt-var-ragged256", SERVE),
         ("serve-25pt-const-exact256", {"traffic": dict(
             SERVE["traffic"], axes=[16])})]


def run(name, overrides, seed=21):
    return harness.run_cell(name, seed, 0.6, False, device="cpu",
                            overrides=overrides)


def unchanged(spec, state, coeffs, n_steps, **kw):
    """A step that returns its state unchanged."""
    return state


def altered(real):
    """The right answers with each grid's middle value flipped where they
    are produced."""
    def fn(spec, state, coeffs, n_steps, **kw):
        cur, prev = real(spec, state, coeffs, n_steps, **kw)
        cur = cur.clone()
        mid = (...,) + tuple(n // 2 for n in cur.shape[-3:])
        cur[mid] = -cur[mid]
        return cur, prev
    return fn


def half_batch(real):
    """A batched launch that leaves the second half of its batch out: those
    members come back as they went in."""
    def fn(spec, states, coeffs, n_steps, **kw):
        cur, prev = real(spec, states, coeffs, n_steps, **kw)
        if isinstance(states, (tuple, list)) and getattr(
                states[0], "ndim", 0) == 4:
            c0, p0 = states
        else:
            c0 = torch.stack([s[0] for s in states])
            p0 = torch.stack([s[1] for s in states])
        cur, prev = cur.clone(), prev.clone()
        b = cur.shape[0]
        cur[b // 2:], prev[b // 2:] = c0[b // 2:], p0[b // 2:]
        return cur, prev
    return fn


def f32_control(spec, state, coeffs, n_steps, **kw):
    """The reference in float32 in the program's place."""
    from repro_torch.core import ir
    arrays, scalars = ir.split_coeffs(spec, coeffs)
    cur, prev = ref.advance(spec.name, state, arrays, scalars, n_steps,
                            dtype=torch.float32)
    return cur.to(state[0].dtype), prev.to(state[0].dtype)


@pytest.mark.parametrize("name,overrides", CELLS, ids=[c[0] for c in CELLS])
def test_sound_run_is_correct(name, overrides):
    out = run(name, overrides)
    assert out["correct"], out["check"]
    assert out["check"]["gap"]["value"] == 0.0
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", ["unchanged", "altered", "control"])
@pytest.mark.parametrize("name", ["solve-7pt-var-512",
                                  "solve-25pt-const-512"])
def test_solve_faults_read_incorrect(name, fault, monkeypatch):
    from repro_torch.kernels import ops
    broken = {"unchanged": unchanged, "altered": altered(ops.mwd),
              "control": f32_control}[fault]
    monkeypatch.setattr(ops, "mwd", broken)
    out = run(name, SOLVE)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("name,overrides", CELLS[2:],
                         ids=[c[0] for c in CELLS[2:]])
def test_serve_faults_read_incorrect(name, overrides, fault, monkeypatch):
    from repro_torch.kernels import ops
    real = ops.mwd_batched
    broken = {"half_batch": half_batch(real),
              "altered": altered(real)}[fault]
    monkeypatch.setattr(ops, "mwd_batched", broken)
    out = run(name, overrides)
    assert not out["correct"], out["check"]
