"""F1: the port's ops.mwd(plan="auto") runs wherever the reference's does.

`plan="auto"` used to resolve to a fixed ``dw8.nf2`` for every op, which
the MWD kernel refuses for any op whose 2R does not divide 8 (the README's
custom op aniso11, R = 3). It now resolves registry-first, then through the
model-scored tuner, as the reference's does. For the four paper ops and
aniso11 at the shapes of tests/test_torch_mwd.py, the port's result stays
within `op.tolerance("f32")` of the reference's own ``plan="auto"`` run
(interpret mode, as its own tests run it). Both registries point at empty
temporary files, so both resolve through their models.
"""

import jax
import numpy as np
import pytest

from repro.core import registry as rreg
from repro.kernels import ops as rops
from repro_torch.kernels import ops as tops
from test_torch_mwd import (SHAPES_R1, SHAPES_R4, assert_within, carry,
                            ops_pair)

NAMES = ["7pt-const", "7pt-var", "25pt-const", "25pt-var", "aniso11"]


@pytest.fixture(autouse=True)
def _empty_registries(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY",
                       str(tmp_path / "port-plans.json"))
    monkeypatch.setenv(rreg.ENV_VAR, str(tmp_path / "ref-plans.json"))


@pytest.mark.parametrize("name", NAMES)
def test_auto_plan_runs_where_the_reference_runs(name):
    rspec, tspec = ops_pair(name)
    shapes = SHAPES_R1 if rspec.radius == 1 else SHAPES_R4
    for i, shape in enumerate(shapes):
        (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, shape,
                                                   seed=i)
        want = rops.mwd(rspec, rstate, rcoeffs, 3, plan="auto")
        jax.block_until_ready(want)
        got = tops.mwd(tspec, state, coeffs, 3, plan="auto")
        for g, w in zip(got, want):
            assert np.isfinite(g.double().numpy()).all()
            assert_within(g, w, tspec.tolerance("f32"))


def test_auto_plan_for_aniso11_on_the_f1_grid():
    """The inputs F1 was found with: aniso11, (10, 18, 20), seed 0, 3 steps."""
    rspec, tspec = ops_pair("aniso11")
    (rstate, rcoeffs), (state, coeffs) = carry(rspec, tspec, (10, 18, 20),
                                               seed=0)
    want = rops.mwd(rspec, rstate, rcoeffs, 3, plan="auto")
    got = tops.mwd(tspec, state, coeffs, 3, plan="auto")
    for g, w in zip(got, want):
        assert_within(g, w, tspec.tolerance("f32"))
