"""The frozen reference against the program's plain oracle, and the
control against the reference."""

import json
import re
from pathlib import Path

import pytest
import torch

from girih_bench import check, harness, inputs
from girih_bench.reference import stencils as ref

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = [json.loads(p.read_text())
           for p in sorted((BENCH / "configs").glob("*.json"))]
REFERENCES = sorted(p.stem for p in ref.OPERATORS_DIR.glob("*.json"))


def _axis_taps(d):
    return [(-d, 0, 0), (d, 0, 0), (0, -d, 0), (0, d, 0), (0, 0, -d),
            (0, 0, d)]


# the reference's taps as the benchmark first froze them, in its order
FROZEN = {
    "7pt-var": {
        "radius": 1, "time_order": 1, "scale": None,
        "groups": [("array", 0, [(0, 0, 0)])]
        + [("array", 1 + k, [off]) for k, off in enumerate(_axis_taps(1))],
    },
    "25pt-const": {
        "radius": 4, "time_order": 2, "scale": ("array", 0),
        "groups": [("const", 0, [(0, 0, 0)])]
        + [("const", d, _axis_taps(d)) for d in range(1, 5)],
    },
}


def paper_ops():
    from repro_torch.core import ir
    return ir.OPS


def problem(config, dtype, grid, seed):
    cfg = {"dtype": dtype, "draw": config["draw"]}
    gen = inputs.generator(seed, "cpu")
    arrays, scalars = inputs.coefficients(cfg, grid, gen, "cpu")
    return inputs.Problem(inputs.levels(cfg, grid, gen, "cpu"), arrays,
                          scalars)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("config", CONFIGS,
                         ids=[c["operator"] for c in CONFIGS])
def test_reference_equals_port_naive(config, dtype):
    from repro_torch.core import ir
    from repro_torch.kernels import ops
    p = problem(config, dtype, (13, 17, 11), seed=5)
    want = ops.naive(ir.resolve_op(config["operator"]), p.state, p.coeffs, 6)
    got = ref.advance(ref.name_of(config), p.state, p.arrays, p.scalars, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("operator",
                         [r for r in REFERENCES if r in paper_ops()])
def test_reference_taps_are_the_papers(operator):
    op = paper_ops()[operator]
    mine = ref.load(operator)
    theirs = tuple((c.kind, c.index, tuple(t.offset for t in taps))
                   for c, taps in op.groups)
    assert mine["groups"] == theirs
    assert mine["radius"] == op.radius
    assert mine["time_order"] == op.time_order
    scale = None if op.scale is None else (op.scale.kind, op.scale.index)
    assert mine["scale"] == scale


@pytest.mark.parametrize("operator", sorted(FROZEN))
def test_reference_files_hold_the_frozen_taps(operator):
    """The files hold the taps the benchmark first froze, groups and the
    taps in each in the same order (the reference sums in listed order)."""
    want = FROZEN[operator]
    got = ref.load(operator)
    assert got["radius"] == want["radius"]
    assert got["time_order"] == want["time_order"]
    assert got["scale"] == want["scale"]
    assert [(k, slot, list(offs)) for k, slot, offs in got["groups"]] == \
        want["groups"]


def test_unknown_operator_names_the_file_it_looked_for(tmp_path):
    state = (torch.zeros(4, 4, 4), torch.zeros(4, 4, 4))
    path = ref.OPERATORS_DIR / "no-such-op.json"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        ref.advance("no-such-op", state, None, (), 1)
    with pytest.raises(FileNotFoundError,
                       match=re.escape(str(tmp_path / "7pt-var.json"))):
        ref.load("7pt-var", root=tmp_path)


@pytest.mark.parametrize("config", CONFIGS,
                         ids=[c["operator"] for c in CONFIGS])
def test_control_fails_the_limit(config):
    """The reference in float32 reads a gap far above the limit of every
    cell; the reference against itself reads 0."""
    name = ref.name_of(config)
    p = problem(config, "float64", (24, 20, 28), seed=9)
    want = ref.advance(name, p.state, p.arrays, p.scalars, 8)
    low = ref.advance(name, p.state, p.arrays, p.scalars, 8,
                      dtype=torch.float32)
    limit = max(check.limits(w["name"])["gap"]
                for w in harness.manifest()["workloads"])
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
