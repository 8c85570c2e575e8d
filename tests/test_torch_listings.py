"""The port's Listings 1-4 against the reference's, and the port's generated
sweep pinned bitwise to them (as tests/test_ir.py pins the reference's).

Inputs are made by the reference's `make_problem` and carried across with
`problem_from_numpy`, so both packages compute on identical numbers.
"""

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as hst

from repro.core import ir as rir
from repro.core import listings as rlist
from repro.core import stencils as rst
from repro_torch.core import ir as tir
from repro_torch.core import listings as tlist
from repro_torch.core import stencils as tst

# (op, reference listing, port listing): paired by the tests only
LISTINGS = [
    ("7pt-const", rlist.sweep_7pt_const, tlist.sweep_7pt_const),
    ("7pt-var", rlist.sweep_7pt_var, tlist.sweep_7pt_var),
    ("25pt-const", rlist.sweep_25pt_const, tlist.sweep_25pt_const),
    ("25pt-var", rlist.sweep_25pt_var, tlist.sweep_25pt_var),
]


def legacy_coeffs(name, arrays, coeffs):
    """The packed form the hand-written listings expect."""
    if name == "25pt-const":
        return (arrays[0], coeffs[1])       # (C 3-D, scalar vector)
    return coeffs


def carried(name, shape, seed):
    """The reference's problem and the same numbers as port tensors."""
    rspec, tspec = rst.SPECS[name], tst.SPECS[name]
    state, coeffs = rir.make_problem(rspec, shape, seed=seed)
    np_state = tuple(np.asarray(s) for s in state)
    np_coeffs = jax.tree_util.tree_map(np.asarray, coeffs)
    return ((state, coeffs),
            tir.problem_from_numpy(tspec, np_state, np_coeffs, device="cpu"))


def port_listing(name, listing, state, coeffs):
    arrays, _ = tir.split_coeffs(tst.SPECS[name], coeffs)
    return listing(state[0], state[1], legacy_coeffs(name, arrays, coeffs))


def generated(name, state, coeffs):
    spec = tst.SPECS[name]
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    return tir.make_sweep(spec)(state[0], state[1], arrays, scalars)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name,ref,port", LISTINGS)
def test_listing_matches_reference_listing(name, ref, port, seed):
    (rstate, rcoeffs), (state, coeffs) = carried(name, (11, 13, 12), seed)
    rarrays, _ = rir.split_coeffs(rst.SPECS[name], rcoeffs)
    want = np.asarray(ref(rstate[0], rstate[1],
                          legacy_coeffs(name, rarrays, rcoeffs)))
    got = port_listing(name, port, state, coeffs).numpy()
    atol, rtol = tst.SPECS[name].tolerance("f32")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name,ref,port", LISTINGS)
def test_generated_sweep_bitwise_equals_listing(name, ref, port, seed):
    _, (state, coeffs) = carried(name, (11, 13, 12), seed)
    got = generated(name, state, coeffs)
    want = port_listing(name, port, state, coeffs)
    assert got.dtype == want.dtype and torch.equal(got, want)


@settings(max_examples=12, deadline=None)
@given(seed=hst.integers(0, 2**16), pick=hst.integers(0, 3),
       shape=hst.sampled_from([(9, 11, 10), (10, 13, 12), (12, 10, 11)]))
def test_generated_sweep_bitwise_property(seed, pick, shape):
    name, _, port = LISTINGS[pick]
    state, coeffs = tst.make_problem(tst.SPECS[name], shape, seed=seed,
                                     device="cpu")
    got = generated(name, state, coeffs)
    assert torch.equal(got, port_listing(name, port, state, coeffs))


@pytest.mark.parametrize("name,ref,port", LISTINGS)
def test_listing_keeps_the_frame_and_leaves_its_input(name, ref, port):
    """The update writes the interior only, into a copy of cur."""
    state, coeffs = tst.make_problem(tst.SPECS[name], (10, 12, 11), seed=3,
                                     device="cpu")
    before = state[0].clone()
    out = port_listing(name, port, state, coeffs)
    r = tst.SPECS[name].radius
    assert torch.equal(state[0], before)
    frame = torch.ones_like(out, dtype=torch.bool)
    frame[r:-r, r:-r, r:-r] = False
    assert torch.equal(out[frame], before[frame])
    assert not torch.equal(out[~frame], before[~frame])
