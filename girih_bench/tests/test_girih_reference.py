"""The frozen reference against the program's plain oracle, and the
control against the reference."""

import pytest
import torch

from girih_bench import check, inputs
from girih_bench.reference import stencils as ref

OPERATORS = {"7pt-var": {"levels": 1, "coeff_arrays": 7, "coeff_scale": 0.1,
                         "scalars": []},
             "25pt-const": {"levels": 2, "coeff_arrays": 1,
                            "coeff_scale": 0.1,
                            "scalars": [0.1, 0.06, 0.045, 0.03, 0.015]}}


def problem(operator, dtype, grid, seed):
    cfg = {"dtype": dtype, "draw": OPERATORS[operator]}
    gen = inputs.generator(seed, "cpu")
    arrays, scalars = inputs.coefficients(cfg, grid, gen, "cpu")
    return inputs.Problem(inputs.levels(cfg, grid, gen, "cpu"), arrays,
                          scalars)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_reference_equals_port_naive(operator, dtype):
    from repro_torch.core import ir
    from repro_torch.kernels import ops
    p = problem(operator, dtype, (13, 17, 11), seed=5)
    want = ops.naive(ir.OPS[operator], p.state, p.coeffs, 6)
    got = ref.advance(operator, p.state, p.arrays, p.scalars, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_reference_taps_are_the_papers(operator):
    from repro_torch.core import ir
    op = ir.OPS[operator]
    mine = [(kind, slot, [tuple(o) for o in offs])
            for kind, slot, offs in ref.OPERATORS[operator]["groups"]]
    theirs = [(c.kind, c.index, [t.offset for t in taps])
              for c, taps in op.groups]
    assert mine == theirs
    assert ref.OPERATORS[operator]["radius"] == op.radius
    assert ref.OPERATORS[operator]["time_order"] == op.time_order


@pytest.mark.parametrize("operator", sorted(OPERATORS))
def test_control_fails_the_limit(operator):
    """The reference in float32 reads a gap far above the limit of every
    cell; the reference against itself reads 0."""
    p = problem(operator, "float64", (24, 20, 28), seed=9)
    want = ref.advance(operator, p.state, p.arrays, p.scalars, 8)
    low = ref.advance(operator, p.state, p.arrays, p.scalars, 8,
                      dtype=torch.float32)
    limit = max(check.limits(w)["gap"] for w in (
        "solve-7pt-var-512", "solve-25pt-const-512",
        "serve-7pt-var-ragged256", "serve-25pt-const-exact256"))
    assert check.state_gap(low, want) > 10 * limit
    assert check.state_gap(want, want) == 0.0


def test_block_gap_sees_a_deep_small_error():
    """A wrong value where the solution is tiny counts by its block's own
    magnitude, not the grid's."""
    want = torch.ones(16, 16, 16, dtype=torch.float64)
    want[8:12, 8:12, 8:12] = 1e-12
    got = want.clone()
    got[9, 9, 9] *= 1.5
    assert check.block_gap(got, want) == pytest.approx(0.5)
    assert float((got - want).abs().max()) < 1e-12
    bad = want.clone()
    bad[0, 0, 0] = float("nan")
    assert check.block_gap(bad, want) == check.NOT_FINITE
    assert check.block_gap(want[:8], want) == check.NOT_FINITE


def test_verdict_needs_every_number():
    assert check.verdict({"gap": 0.0}, {"gap": 1e-9})[0]
    assert not check.verdict({"gap": 1e-8}, {"gap": 1e-9})[0]
    assert not check.verdict({}, {"gap": 1e-9})[0]
