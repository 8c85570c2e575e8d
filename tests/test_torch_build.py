"""How the port names its CUDA builds, and the C tables the launchers get.

Runs without nvcc or a card: it only computes build paths and host tables.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core import stencils as tst
from repro_torch.kernels import _build, _host


def test_build_target_hashes_shared_headers(tmp_path):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    src, first = _build._target("k", tmp_path, tmp_path / "build")
    assert src == tmp_path / "k.cu"
    assert _build._target("k", tmp_path, tmp_path / "build")[1] == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build._target("k", tmp_path, tmp_path / "build")[1]
    assert second != first
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert _build._target("k", tmp_path, tmp_path / "build")[1] != second
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("libk-") and first.suffix == ".so"


def test_every_kernel_source_includes_the_shared_cell():
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sources == ["fused.cu", "mwd.cu", "sweep.cu"]
    for name in sources:
        text = (_build.CSRC / name).read_text()
        assert '#include "stencil_cell.cuh"' in text
        assert "update_cell<" in text


def test_the_lattice_update_is_defined_only_in_the_shared_cell():
    """No kernel source carries its own copy of the arithmetic."""
    header = (_build.CSRC / "stencil_cell.cuh").read_text()
    definition = re.compile(r"\bvoid\s+(update_cell\w*|tap_sum\w*)\s*\(")
    assert sorted(definition.findall(header)) == ["tap_sum", "update_cell"]
    for path in sorted(_build.CSRC.glob("*.cu")):
        assert definition.findall(path.read_text()) == [], path.name


def test_the_async_copies_are_defined_only_in_their_header():
    """K1 and K3 stream planes with the one copy of the cp.async helpers."""
    header = (_build.CSRC / "async_copy.cuh").read_text()
    definition = re.compile(
        r"\bvoid\s+(copy_async|copy_row|cp_async_commit|cp_async_wait)\s*\(")
    assert sorted(definition.findall(header)) == [
        "copy_async", "copy_row", "cp_async_commit", "cp_async_wait"]
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        assert definition.findall(text) == [], path.name
        if path.name in ("mwd.cu", "fused.cu", "sweep.cu"):
            assert '#include "async_copy.cuh"' in text


@pytest.mark.parametrize("name", list(tst.SPECS))
def test_op_tables_follow_group_order(name):
    spec = tst.SPECS[name]
    scalars = tuple(0.1 * (i + 1) for i in range(spec.n_scalars))
    sz, sy = 1000, 30
    taps, groups, values = _host.op_tables(spec, scalars, sz, sy)
    members = [t for _, ts in spec.groups for t in ts]
    assert taps.tolist() == [t.dz * sz + t.dy * sy + t.dx for t in members]
    n = len(spec.groups)
    assert groups.dtype == np.int32 and len(groups) == 3 * n + 2
    assert sum(groups[0:3 * n:3]) == len(spec.taps)
    assert len(values) == n + 1
    if spec.scale is None:
        assert groups[-2:].tolist() == [-1, 0]


def test_kernel_input_checks_refuse_cpu_tensors():
    a = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        _host.check_kernel_inputs("sweep", [a, a])
