"""The port's MWD oracles and `ops.mwd` vs the JAX reference, plus its invariants.

The reference runs its Pallas kernel in interpret mode, as its own tests
do, at the sizes of tests/test_kernels.py. Parity across frameworks is held
to `op.tolerance(dtype)`; the port's own invariants (plain kernel version
== compiled-table oracle, fused == per-row, batched == per-item loop,
``n_steps = 0`` identity) are held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir
from repro.core import stencils as rst
from repro.kernels import ops as rops
from repro.kernels import stencil_mwd as rmwd
from repro_torch.core import ir as tir
from repro_torch.core import mwd as tmwd
from repro_torch.core import registry as treg
from repro_torch.core import stencils as tst
from repro_torch.kernels import _host
from repro_torch.kernels import ops as tops
from repro_torch.kernels import stencil_mwd as tkern

SHAPES_R1 = [(6, 10, 12), (10, 20, 24), (9, 17, 31)]
SHAPES_R4 = [(10, 18, 14), (13, 21, 18)]


def aniso11(irmod):
    """README's custom op: variable z/y star + radius-3 constant x star."""
    taps = [irmod.Tap(0, 0, 0, irmod.array(0)),
            irmod.Tap(-1, 0, 0, irmod.array(1)),
            irmod.Tap(1, 0, 0, irmod.array(1)),
            irmod.Tap(0, -1, 0, irmod.array(2)),
            irmod.Tap(0, 1, 0, irmod.array(2))]
    taps += [irmod.Tap(0, 0, s * d, irmod.const(d - 1))
             for d in (1, 2, 3) for s in (1, -1)]
    return irmod.StencilOp("aniso11", tuple(taps),
                           default_scalars=(0.08, 0.04, 0.02))


def ops_pair(name):
    if name == "aniso11":
        return aniso11(rir), aniso11(tir)
    return rst.SPECS[name], tst.SPECS[name]


def carry(rspec, tspec, shape, dtype=jnp.float32, seed=0):
    state, coeffs = rir.make_problem(rspec, shape, dtype=dtype, seed=seed)
    np_state = tuple(np.asarray(s) for s in state)
    np_coeffs = jax.tree_util.tree_map(np.asarray, coeffs)
    return (state, coeffs), tir.problem_from_numpy(tspec, np_state, np_coeffs,
                                                   device="cpu")


def assert_within(got, want, tol):
    atol, rtol = tol
    g = got.double().numpy()
    w = np.asarray(want).astype(np.float64)
    assert g.shape == w.shape
    err = np.abs(g - w)
    assert np.all(err <= atol + rtol * np.abs(w)), float(err.max())


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(rst.SPECS))
@pytest.mark.parametrize("t_steps,k,n_f", [(4, 1, 2), (3, 2, 4)])
def test_port_matches_reference_mwd(name, t_steps, k, n_f):
    """run_mwd / run_compiled / ops.mwd (fused, per-row) vs reference ops.mwd."""
    rspec, tspec = ops_pair(name)
    d_w = 2 * rspec.radius * k
    if d_w % n_f:
        n_f = d_w
    shape = SHAPES_R1[1] if rspec.radius == 1 else SHAPES_R4[1]
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, seed=4)
    want = rops.mwd(rspec, rstate, rcoeffs, t_steps, d_w=d_w, n_f=n_f)
    tol = tspec.tolerance("f32")
    plan = tmwd.MWDPlan(d_w=d_w, n_f=n_f)
    oracle = tmwd.run_mwd(tspec, state, coeffs, t_steps, plan)
    compiled = tmwd.run_compiled(tspec, state, coeffs, t_steps, plan)
    fused = tops.mwd(tspec, state, coeffs, t_steps, d_w=d_w, n_f=n_f)
    row = tops.mwd(tspec, state, coeffs, t_steps, d_w=d_w, n_f=n_f,
                   fused=False)
    for got in (oracle, compiled, fused, row):
        for g, w in zip(got, want):
            assert_within(g, w, tol)
    assert_bitwise(fused, row)
    assert_bitwise(fused, compiled)
    assert_bitwise(compiled, oracle)


def test_custom_mixed_op_matches_reference():
    rspec, tspec = ops_pair("aniso11")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (9, 20, 15),
                                               seed=6)
    want = rops.mwd(rspec, rstate, rcoeffs, 4, d_w=6, n_f=3)
    got = tops.mwd(tspec, state, coeffs, 4, d_w=6, n_f=3)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))
    assert_bitwise(got, tops.mwd(tspec, state, coeffs, 4, d_w=6, n_f=3,
                                 fused=False))


def test_nonmultiple_grid_matches_reference():
    rspec, tspec = ops_pair("7pt-const")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (11, 19, 13),
                                               seed=9)
    want = rops.mwd(rspec, rstate, rcoeffs, 5, d_w=8, n_f=4)
    got = tops.mwd(tspec, state, coeffs, 5, d_w=8, n_f=4)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))
    naive = tops.naive(tspec, state, coeffs, 5)
    assert_bitwise(got, naive)


@pytest.mark.parametrize("name,dt,jdt,acc", [
    ("7pt-const", "bf16", jnp.bfloat16, "auto"),
    ("7pt-const", "fp16", jnp.float16, "auto"),
    ("25pt-const", "bf16", jnp.bfloat16, "auto"),
    ("25pt-const", "fp16", jnp.float16, "auto"),
    ("7pt-const", "bf16", jnp.bfloat16, "native"),
    ("7pt-var", "fp16", jnp.float16, "native"),
])
def test_reduced_precision_matches_reference(name, dt, jdt, acc):
    """bf16/fp16 streams, f32 or native accumulation, within op.tolerance.

    Native accumulation is not bitwise across frameworks: PyTorch multiplies
    a Python-float scalar in float32 while JAX rounds it to the stream type.
    """
    rspec, tspec = ops_pair(name)
    shape = (8, 16, 16) if rspec.radius == 1 else (12, 18, 14)
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape, jdt,
                                               seed=5)
    want = rops.mwd(rspec, rstate, rcoeffs, 2, d_w=2 * rspec.radius, n_f=2,
                    acc=acc)
    got = tops.mwd(tspec, state, coeffs, 2, d_w=2 * tspec.radius, n_f=2,
                   acc=acc)
    assert got[0].dtype == state[0].dtype
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance(dt))
    row = tops.mwd(tspec, state, coeffs, 2, d_w=2 * tspec.radius, n_f=2,
                   acc=acc, fused=False)
    assert_bitwise(got, row)


def test_dtype_argument_casts_like_reference():
    rspec, tspec = ops_pair("7pt-var")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (8, 14, 10),
                                               seed=2)
    want = rops.mwd(rspec, rstate, rcoeffs, 2, d_w=4, n_f=2, dtype="bf16")
    got = tops.mwd(tspec, state, coeffs, 2, d_w=4, n_f=2, dtype="bf16")
    assert got[0].dtype == torch.bfloat16
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("bf16"))


def test_zero_steps_is_identity_with_synced_frame():
    rspec, tspec = ops_pair("25pt-const")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (12, 18, 14),
                                               seed=1)
    want = rops.mwd(rspec, rstate, rcoeffs, 0)
    got = tops.mwd(tspec, state, coeffs, 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert torch.equal(got[0], state[0])
    assert not torch.equal(got[1], state[1])    # the frame was synced


def test_runtime_interior_and_y_domain_match_reference():
    """Dynamic interior bounds and a full-y tessellation, as the stepper passes."""
    rspec, tspec = ops_pair("7pt-var")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (10, 20, 12),
                                               seed=8)
    interior = (2, 8, 1, 17, 3, 11)
    rarr, rsca = rir.split_coeffs(rspec, rcoeffs)
    want = rmwd.mwd_run(rspec, rstate, rarr, rsca, 3, d_w=4, n_f=2,
                        interior=jnp.asarray(interior, jnp.int32),
                        y_domain=(0, 20))
    tarr, tsca = tir.split_coeffs(tspec, coeffs)
    got = tkern.mwd_run(tspec, state, tarr, tsca, 3, d_w=4, n_f=2,
                        interior=interior, y_domain=(0, 20))
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))
    with pytest.raises(ValueError, match="interior"):
        tkern.mwd_run(tspec, state, tarr, tsca, 3, d_w=4, n_f=2,
                      interior=(0, 11, 1, 17, 3, 11))


def test_batched_matches_reference():
    rspec, tspec = ops_pair("7pt-var")
    pairs = [carry(rspec, tspec, (8, 14, 10), seed=s) for s in (0, 1)]
    want = rops.mwd_batched(rspec, [p[0][0] for p in pairs],
                            [p[0][1] for p in pairs], 3, d_w=4, n_f=2)
    got = tops.mwd_batched(tspec, [p[1][0] for p in pairs],
                           [p[1][1] for p in pairs], 3, d_w=4, n_f=2)
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))


# ---------------------------------------------------------------------------
# The port's own invariants, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(tst.SPECS) + ["aniso11"])
def test_batched_bitwise_equals_per_item_loop(name):
    spec = aniso11(tir) if name == "aniso11" else tst.SPECS[name]
    d_w = 6 if name == "aniso11" else 2 * spec.radius
    shape = (8, 14, 10) if spec.radius == 1 else (12, 18, 14)
    probs = [tst.make_problem(spec, shape, seed=s, device="cpu")
             for s in (0, 1, 2)]
    cur, prev = tops.mwd_batched(spec, [p[0] for p in probs],
                                 [p[1] for p in probs], 3, d_w=d_w, n_f=2)
    for i, (state, coeffs) in enumerate(probs):
        want = tops.mwd(spec, state, coeffs, 3, d_w=d_w, n_f=2)
        assert_bitwise((cur[i], prev[i]), want)


def test_batched_per_row_stacked_and_shared_coeffs():
    spec = tst.SPECS["7pt-const"]
    probs = [tst.make_problem(spec, (8, 14, 10), seed=s, device="cpu")
             for s in (3, 4)]
    states = [p[0] for p in probs]
    fused = tops.mwd_batched(spec, states, [p[1] for p in probs], 3,
                             d_w=4, n_f=2)
    row = tops.mwd_batched(spec, states, [p[1] for p in probs], 3,
                           d_w=4, n_f=2, fused=False)
    assert_bitwise(fused, row)
    stacked = (torch.stack([s[0] for s in states]),
               torch.stack([s[1] for s in states]))
    shared = tops.mwd_batched(spec, stacked, probs[0][1], 3, d_w=4, n_f=2)
    assert_bitwise(fused, shared)


def test_batched_refusals():
    spec = tst.SPECS["7pt-const"]
    (s0, c0) = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    (s1, c1) = tst.make_problem(spec, (8, 14, 10), dtype="bf16", seed=1,
                                device="cpu")
    with pytest.raises(ValueError, match="mixed-dtype"):
        tops.mwd_batched(spec, [s0, s1], [c0, c1], 2, d_w=4, n_f=2)
    got = tops.mwd_batched(spec, [s0, s1], [c0, c0], 2, d_w=4, n_f=2,
                           dtype="f32")
    assert got[0].dtype == torch.float32
    with pytest.raises(ValueError, match="share"):
        tops.mwd_batched(spec, [s0, s0], [c0, (0.4, 0.2)], 2, d_w=4, n_f=2)
    with pytest.raises(ValueError, match="coefficient sets"):
        tops.mwd_batched(spec, [s0, s0], [c0], 2, d_w=4, n_f=2)
    with pytest.raises(ValueError, match="B, nz, ny, nx"):
        tkern.mwd_run_batched(spec, s0, None, c0, 2)


def test_plan_resolution_and_geometry_checks(tmp_path, monkeypatch):
    monkeypatch.setenv(treg.ENV_VAR, str(tmp_path / "plans.json"))
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    auto = tops.resolve_plan(spec, state, "auto")
    assert (auto, "model") == treg.resolve_plan(spec, (8, 14, 10),
                                                word_bytes=4)
    explicit = tmwd.MWDPlan(d_w=4, n_f=4, fused=False)
    assert tops.resolve_plan(spec, state, explicit) is explicit
    with pytest.raises(ValueError, match="auto"):
        tops.resolve_plan(spec, state, "tuned")
    assert_bitwise(tops.mwd(spec, state, coeffs, 3, plan="auto"),
                   tops.mwd(spec, state, coeffs, 3, d_w=auto.d_w,
                            n_f=auto.n_f, fused=auto.fused))
    with pytest.raises(ValueError, match="2R"):
        tops.mwd(spec, state, coeffs, 2, d_w=5, n_f=1)
    with pytest.raises(ValueError, match="n_f"):
        tops.mwd(spec, state, coeffs, 2, d_w=8, n_f=3)
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    with pytest.raises(ValueError, match="coefficient streams"):
        tkern.mwd_run(spec, state, arrays.double(), scalars, 2, d_w=4, n_f=2)


def test_edge_pad_matches_jnp_edge_mode():
    a = np.random.default_rng(0).standard_normal((2, 3, 4, 5))
    pads = ((1, 3), (2, 2), (1, 1))
    want = np.pad(a, ((0, 0),) + pads, mode="edge")
    got = _host.edge_pad(torch.from_numpy(a), pads)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_never_reach_the_kernel():
    spec = tst.SPECS["7pt-const"]
    state, coeffs = tst.make_problem(spec, (8, 14, 10), seed=0, device="cpu")
    before = tkern.LAUNCHES.count
    tops.mwd(spec, state, coeffs, 3, d_w=4, n_f=2)
    assert tkern.LAUNCHES.count == before
    job = tkern.prepare(spec, state, None, coeffs, 3, d_w=4, n_f=2,
                        fused=True)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.run_kernel(job)


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is usable here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.make_problem(tst.SPECS["7pt-const"], (8, 8, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        tir.problem_from_numpy(tst.SPECS["7pt-const"],
                               (np.zeros((4, 4, 4)),) * 2, (0.4, 0.1))
