"""K1's star instances on the CPU: which ops take them, and their update.

`_host.star_layout` matches an op's taps (in `op.groups` order), group
sizes and groups' coefficient kinds against the layouts K1 compiles in
(`Star<L>` of
``csrc/stencil_cell.cuh``). The shared cell is also built here with the
host's C++ compiler, CUDA's headers stood in for, so that its star form of
`update_cell` is held bit for bit against the generic form, and its layouts
against the ops the host matches. The kernel itself runs in
``tests/test_torch_gpu.py``.
"""

import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from girih_bench import harness
from repro_torch.core import ir as tir
from repro_torch.core import padding
from repro_torch.core import stencils as tst
from repro_torch.core import trace
from repro_torch.kernels import _build, _host
from repro_torch.kernels import stencil_mwd as tkern

PAPER = ["7pt-const", "7pt-var", "25pt-const", "25pt-var"]


def _star(radius, coeff):
    """A star of `radius` with the centre, then each axis out and back."""
    taps = [tir.Tap(0, 0, 0, tir.array(0))]
    for ax in range(3):
        for d in range(1, radius + 1):
            for s in (-1, 1):
                off = [0, 0, 0]
                off[ax] = s * d
                taps.append(tir.Tap(*off, coeff(ax, d)))
    return tir.StencilOp(f"star{radius}", tuple(taps))


def _no_star_ops():
    """Ops that keep K1's generic instance."""
    v, c = tst.SPECS["7pt-var"], tst.SPECS["25pt-const"]
    swapped = (v.taps[0], v.taps[2], v.taps[1]) + v.taps[3:]
    reordered = (c.taps[0],) + tuple(reversed(c.taps[1:]))
    box = tuple(tir.Tap(dz, dy, dx, tir.const(int(abs(dz) + abs(dy)
                                                   + abs(dx) > 0)))
                for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                for dx in (-1, 0, 1))
    return {
        "7pt-var-swapped": tir.StencilOp("7pt-var-swapped", swapped),
        "25pt-const-reordered": tir.StencilOp(
            "25pt-const-reordered", reordered, time_order=2, scale=c.scale),
        "7pt-var-diagonal": tir.StencilOp("7pt-var-diagonal", v.taps + (
            tir.Tap(1, 1, 0, tir.array(7)),)),
        "star2": _star(2, lambda ax, d: tir.array(1 + ax)),
        "star3": _star(3, lambda ax, d: tir.const(d - 1)),
        "box27": tir.StencilOp("box27", box),
        "7pt-var-const-centre": tir.StencilOp("7pt-var-const-centre", (
            tir.Tap(0, 0, 0, tir.const(0)),) + tuple(
                tir.Tap(*t.offset, tir.array(i)) for i, t in
                enumerate(v.taps[1:]))),
        "25pt-const.T": tir.adjoint(c).op,
        "25pt-var.T": tir.adjoint(tst.SPECS["25pt-var"]).op,
    }


@pytest.mark.parametrize("code,name", list(enumerate(PAPER, 1)))
def test_paper_ops_take_their_star_layout(code, name):
    assert _host.star_layout(tst.SPECS[name]) == code


@pytest.mark.parametrize("name,code", [("7pt-const", 7), ("7pt-var", 2),
                                       ("25pt-const", 3), ("25pt-var", 4)])
def test_masked_twins_take_a_layout(name, code):
    """The +mask twins keep their op's taps and groups: 7pt-const's turns
    its groups into streams (a layout of its own), the others are their
    ops."""
    assert _host.star_layout(padding.masked_variant(tst.SPECS[name])) == code


@pytest.mark.parametrize("code,name", [(5, "7pt-const"), (6, "7pt-var")])
def test_seven_point_adjoints_take_the_negated_layouts(code, name):
    """An adjoint negates every tap; its groups keep their sizes at the
    7-point ops (the 25-point adjoints' 25 one-tap groups match none)."""
    adj = tir.adjoint(tst.SPECS[name]).op
    assert _host.star_layout(adj) == code


@pytest.mark.parametrize("name", list(_no_star_ops()))
def test_other_ops_take_no_star_layout(name):
    assert _host.star_layout(_no_star_ops()[name]) == 0


@pytest.mark.parametrize("dt,acc,star", [
    ("f32", None, True), ("f64", None, True), ("bf16", None, False),
    ("fp16", torch.float32, False), ("f32", torch.float64, False)])
def test_star_code_of_a_job_follows_its_types(dt, acc, star):
    """Star instances exist for f32 and f64 streams in their own precision."""
    spec = tst.SPECS["7pt-var"]
    state, coeffs = tst.make_problem(spec, (8, 12, 10), dtype=dt, seed=1,
                                     device="cpu")
    arrays, scalars = tir.split_coeffs(spec, coeffs)
    job = tkern.prepare(spec, state, arrays, scalars, 2, d_w=4, n_f=2,
                        fused=True, acc_dtype=acc)
    assert tkern.star_code(job) == (2 if star else 0)


def test_star_share_reads_the_counters(monkeypatch):
    """The benchmark's `k1_star_share.solve`: star launches over launches;
    nothing without the star counter or calls."""
    read = harness.reader("k1_star_share.solve")
    monkeypatch.setattr(tkern.LAUNCHES, "count", 40)
    monkeypatch.setattr(tkern.STAR_LAUNCHES, "count", 30)
    assert read({"calls": 2}) == pytest.approx(0.75)
    assert read({"calls": 0}) is None
    monkeypatch.delitem(trace._COUNTERS, "k1.star_launches")
    assert read({"calls": 2}) is None


STUBS = {
    "cuda_runtime.h": "#pragma once\n#define __device__\n#define __host__\n"
                      "#define __forceinline__ inline\n"
                      "typedef int cudaError_t;\n"
                      "static inline const char* cudaGetErrorString("
                      "cudaError_t) { return \"\"; }\n",
    "cuda_bf16.h": "#pragma once\nstruct __nv_bfloat16 { float v; };\n"
                   "static inline float __bfloat162float(__nv_bfloat16 x)"
                   " { return x.v; }\nstatic inline __nv_bfloat16 "
                   "__float2bfloat16_rn(float f) { return {f}; }\n",
    "cuda_fp16.h": "#pragma once\nstruct __half { float v; };\n"
                   "static inline float __half2float(__half x) "
                   "{ return x.v; }\nstatic inline __half "
                   "__float2half_rn(float f) { return {f}; }\n",
}


@pytest.fixture(scope="module")
def host_cell(tmp_path_factory):
    """The shared cell's host check, built (skips without a C++ compiler)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    tmp = tmp_path_factory.mktemp("star_cell")
    for name, text in STUBS.items():
        (tmp / name).write_text(text)
    exe = tmp / "star_cell_check"
    src = Path(__file__).with_name("csrc") / "star_cell_check.cpp"
    # no contraction of a multiply and an add, as nvcc's -fmad=false
    subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    f"-I{tmp}", f"-I{_build.CSRC}", "-include",
                    "cuda_runtime.h", "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True, timeout=300)
    return exe


def _run(exe, ops):
    lines = [str(len(ops))]
    for op in ops:
        offsets, sizes, kinds = _host._layout(op)
        lines.append(f"{len(offsets)} {len(sizes)} " + " ".join(
            f"{n} {int(k == 'array')}" for n, k in zip(sizes, kinds)))
        lines += [" ".join(map(str, o)) for o in offsets]
    out = subprocess.run([str(exe)], input="\n".join(lines) + "\n",
                         check=True, capture_output=True, text=True,
                         timeout=300).stdout.split("\n")
    layouts = [int(x.split()[1]) for x in out if x.startswith("layout")]
    updates = [x.split()[1:] for x in out if x.startswith("update")]
    return layouts, updates


def test_the_cells_layouts_are_the_hosts(host_cell):
    """The header's `Star<L>` matches exactly the ops the host gives code
    L, and none of the others."""
    ops = ([tst.SPECS[n] for n in PAPER]
           + [tir.adjoint(tst.SPECS[n]).op for n in PAPER[:2]]
           + [padding.masked_variant(tst.SPECS[n]) for n in PAPER]
           + list(_no_star_ops().values()))
    layouts, _ = _run(host_cell, ops)
    assert layouts == [_host.star_layout(op) for op in ops]
    assert layouts[:7] == [1, 2, 3, 4, 5, 6, 7]


def test_the_star_update_equals_the_generic_update_bitwise(host_cell):
    """Every layout in f32 and f64, first and second order, every kind of
    scale, one or two cells, every ring slot: the
    star form of update_cell gives the generic form's bits, and its
    offsets are the per-slot table's."""
    _, updates = _run(host_cell, [])
    assert [(int(L), t) for L, t, _, _ in updates] == [
        (L, t) for L in range(1, 8) for t in ("f32", "f64")]
    for L, t, cells, differing in updates:
        assert int(cells) > 1000 and int(differing) == 0, (L, t)
