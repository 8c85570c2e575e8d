"""The port's analytic dry-run (`launch.dryrun`, `launch.roofline`, the
report's section 6) on the CPU, against the reference's.

The reference's closed forms (`model_flops`, `active_params`,
`analytic_hbm_bytes`, `ghostzone_code_balance`) are held to exact
equality on every runnable cell; `tree_sds`, `coeff_sds` and
`extended_coeff_sds` leaf for leaf (shapes, dtype names). The counted
FLOPs run the port's steps on meta tensors; the reference has no
counterpart for them (XLA's cost analysis), so they are held to
MODEL_FLOPS from below, for every config: MoE routing's counts are a
scatter-add, which runs on meta tensors, so no cell takes the
reference's model-flops route any more.
"""

import dataclasses
import json
import os

import jax
import pytest
from jax.sharding import AbstractMesh

from repro import configs as rc
from repro.configs.base import SHAPES as RSHAPES
from repro.core import models as rmodels
from repro.core import stencils as rst
from repro.distributed import stepper as rstepper
from repro.launch import roofline as rroof
from repro.models import lm as rlm
from repro.models import params as rparams
from repro_torch import configs as tc
from repro_torch.core import models as tmodels
from repro_torch.core import stencils as tst
from repro_torch.distributed import stepper as tstepper
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.sweep import RESULTS_DIR
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.optim.optimizers import tree_paths


def reference_dryrun():
    """`repro.launch.dryrun`, imported with the XLA_FLAGS it sets on
    import restored, so this process keeps its device count."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return rdry


def sds_leaves(tree):
    return [(tuple(s.shape), str(s.dtype).replace("torch.", ""))
            for _, s in tree_paths(tree)]


def ref_sds_leaves(tree):
    return [(tuple(s.shape), str(s.dtype))
            for s in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_cell_enumeration_is_the_references():
    cells = list(dryrun.iter_cells("all", "all"))
    lm_cells = [c for c in cells if not c[0].startswith("girih-")]
    girih = [c for c in cells if c[0].startswith("girih-")]
    assert len(lm_cells) == 40
    assert sum(1 for c in lm_cells if not c[2]) == 34
    assert len(girih) == 8
    rdry = reference_dryrun()
    assert cells == list(rdry.iter_cells("all", "all"))
    assert dryrun.GIRIH_GRIDS == rdry.GIRIH_GRIDS
    assert dryrun.MESHES == rdry.MESHES
    for mp in (False, True):
        assert dryrun.mesh_name(mp) == rdry.mesh_name(mp)
    assert list(dryrun.iter_cells("llama3.2-1b", "decode_32k")) \
        == [("llama3.2-1b", "decode_32k", "")]


RUNNABLE = [(a, s) for a, s, skip in dryrun.iter_cells("all", "all")
            if not skip and not a.startswith("girih-")]


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_closed_forms_match_the_reference(arch, shape):
    """active_params, model_flops and analytic_hbm_bytes on both meshes,
    at the launcher's accum rule, exactly."""
    cfg_r, cfg_t = rc.get(arch), tc.get(arch)
    r_tree, t_tree = rlm.param_specs(cfg_r), tlm.param_specs(cfg_t)
    got = roofline.active_params(cfg_t, t_tree)
    assert got == rroof.active_params(cfg_r, r_tree)
    n_total, n_active = got
    accum = 8 if cfg_t.d_model >= 7168 and shape == "train_4k" else 1
    info = RSHAPES[shape]
    assert roofline.model_flops(cfg_t, info, n_total, n_active) \
        == rroof.model_flops(cfg_r, info, n_total, n_active)
    for n_dev in (256, 512):
        assert roofline.analytic_hbm_bytes(
            cfg_t, info, n_total, n_active, n_dev, accum=accum) \
            == rroof.analytic_hbm_bytes(cfg_r, info, n_total, n_active,
                                        n_dev, accum=accum)


@pytest.mark.parametrize("arch", list(rc.ARCH_IDS))
def test_tree_sds_matches_the_reference(arch):
    for stacked in (False, True):
        want = rparams.tree_sds(rlm.param_specs(rc.get(arch),
                                                stacked=stacked))
        got = tparams.tree_sds(tlm.param_specs(tc.get(arch),
                                               stacked=stacked))
        assert sds_leaves(got) == ref_sds_leaves(want)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("op", list(rst.SPECS))
def test_coeff_sds_match_the_reference(op, multi):
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi \
        else ((16, 16), ("data", "model"))
    rmesh = AbstractMesh(shape, axes)
    tm = tmesh.abstract_mesh(shape, axes)
    grid = dryrun.GIRIH_GRIDS["grid_1k"]
    rspec, tspec = rst.SPECS[op], tst.SPECS[op]
    assert sds_leaves(tstepper.coeff_sds(tspec, grid)) \
        == ref_sds_leaves(rstepper.coeff_sds(rspec, grid))
    for tb in (1, 2, 4):
        assert sds_leaves(tstepper.extended_coeff_sds(tspec, tm, grid, tb)) \
            == ref_sds_leaves(rstepper.extended_coeff_sds(rspec, rmesh,
                                                          grid, tb))


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def test_counted_flops_of_a_dense_train_cell_cover_model_flops():
    pod = dryrun.production_mesh(False)
    cfg = tc.reduced(tc.get("llama3.2-1b"))
    probed, mflops, mbytes, arg_bytes, notes = dryrun.count_lm_cell(
        cfg, "train_4k", pod, chunk=512)
    assert probed is not None and "counted/256dev" in notes
    counted = probed["flops"] * 256
    # forward + backward + the remat recompute: more than 6 N D
    assert counted >= mflops > 0
    assert probed["bytes"] > 0 and arg_bytes > 0
    assert set(probed["coll"]) == set(roofline.COLLECTIVES)


@pytest.mark.parametrize("arch", list(rc.ARCH_IDS))
def test_model_flops_route_is_taken_exactly_for_moe(arch):
    """The model-flops route is taken for no config now: MoE steps are
    counted on meta tensors as every other (their routing's counts are a
    scatter-add), their collectives too, and the count covers
    MODEL_FLOPS."""
    cfg = dataclasses.replace(tc.reduced(tc.get(arch)), n_layers=2)
    probed, mflops, *_, notes = dryrun.count_lm_cell(
        cfg, "train_4k", dryrun.production_mesh(False), chunk=1024)
    assert probed is not None and "model-flops" not in notes
    assert "counted/256dev" in notes and "not counted" not in notes
    assert probed["flops"] * 256 >= mflops > 0


def test_count_step_counts_what_the_layers_do():
    """One decode step of a 2-layer dense model: the head's and the
    projections' products, 2 x batch x (active params) FLOPs, plus
    attention over the cache."""
    cfg = dataclasses.replace(tc.reduced(tc.get("llama3.2-1b")),
                              n_layers=2)
    b, seq = 4, 64
    flops, nbytes = dryrun.count_step(cfg, "decode", b, seq)
    n_total, _ = roofline.active_params(cfg, tlm.param_specs(cfg))
    embed = cfg.vocab_size * cfg.d_model
    norms = cfg.d_model * (2 * cfg.n_layers + 1)
    matmul = 2 * b * (n_total - norms)        # tied head reads embed
    attn = 2 * 2 * b * seq * cfg.n_heads * cfg.resolved_head_dim \
        * cfg.n_layers
    assert flops == matmul + attn
    assert embed < n_total and nbytes > 0


def test_run_cell_and_dryrun_result_keys(tmp_path):
    res = dryrun.run_cell("llama3.2-1b", "decode_32k", False,
                          verbose=False)
    ref = rroof.DryrunResult(
        arch="a", shape="s", mesh="m", n_devices=1, flops_per_device=1.0,
        bytes_per_device=1.0, model_bytes_per_device=1.0,
        coll_bytes={k: 0.0 for k in roofline.COLLECTIVES},
        peak_bytes_per_device=1.0, arg_bytes_per_device=1.0,
        model_flops_global=1.0,
        terms=rmodels.roofline(1.0, 1.0, 0.0),
        terms_hlo=rmodels.roofline(1.0, 1.0, 0.0), lower_s=0.0,
        compile_s=0.0)
    js = res.to_json()
    assert list(js) == list(ref.to_json())
    assert js["peak_bytes_per_device"] is None
    assert js["n_devices"] == 256 and js["dominant"] == "memory"
    # priced on the H100 spec's data-sheet peaks
    from repro_torch.core import specs
    h100 = specs.get_spec("h100-sxm")
    # an LM cell's collective bytes: what one device's sharded step
    # issues (the ranks count the same calls: test_torch_lm_sharded.py)
    want = dryrun.count_collectives(
        tc.get("llama3.2-1b"), "decode", RSHAPES["decode_32k"]
        ["global_batch"], RSHAPES["decode_32k"]["seq_len"],
        dryrun.production_mesh(False))
    assert res.coll_bytes == {k: float(want.get(k, 0))
                              for k in roofline.COLLECTIVES}
    assert sum(want.values()) > 0
    assert js["t_collective"] == sum(res.coll_bytes.values()) / (
        h100.ici_bw_per_link * h100.ici_links / 2)
    assert js["t_memory"] == js["model_bytes_per_device"] / h100.hbm_bw
    assert js["t_compute"] == js["flops_per_device"] / h100.peak_flops_bf16
    # girih cells: the reference's ghost-zone code balance, exactly
    g = dryrun.run_cell("girih-25pt-var", "grid_2k", True, verbose=False)
    spec = rst.SPECS["25pt-var"]
    bc = rmodels.ghostzone_code_balance(spec, 2, 2048 // 16, 2048 // 32)
    assert g.model_bytes_per_device == bc * 2048 ** 3 * 2 / 512
    assert g.bytes_per_device is None and "Bc_gz" in g.notes
    assert tmodels.ghostzone_code_balance(tst.SPECS["25pt-var"], 2, 128,
                                          64) == bc
    # its collective bytes: an interior shard's halo slabs a super-step,
    # what the multi-process carrier sends (test_torch_multiprocess.py
    # holds the carrier to the same function), priced one way over NVLink
    from repro_torch.distributed import stepper
    halo = stepper.interior_halo_bytes(
        tst.SPECS["25pt-var"], dryrun.production_mesh(True), (2048,) * 3, 2)
    # 2x16x16: a 64 x 128 x 2048 shard, g = 8, x-padded to 2064; four
    # f32 slabs of the one solution stream
    assert halo == 4 * 2 * (8 * 128 * 2064 + 8 * (64 + 16) * 2064)
    assert g.coll_bytes["collective-permute"] == halo
    assert sum(g.coll_bytes.values()) == halo
    assert g.terms.t_collective == halo / (h100.ici_bw_per_link
                                           * h100.ici_links / 2)


def test_main_writes_records_and_the_report_renders(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-130m", "--shape", "all",
                     "--mesh", "both", "--out", str(out)])
    assert e.value.code == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 8
    assert all("skip" not in r and "error" not in r for r in recs)
    with pytest.raises(SystemExit):          # a second run is all cached
        dryrun.main(["--arch", "mamba2-130m", "--shape", "train_4k",
                     "--mesh", "pod", "--out", str(out)])
    assert "[cached]" in capsys.readouterr().out
    text = "\n".join(report.dryrun_section(recs))
    assert "## 6. Multi-pod dry-run & roofline" in text
    assert "`h100-sxm`" in text and "sharded step issues" in text
    assert text.count("| mamba2-130m |") == 12   # 4 + 4 + the roofline's 4


def test_committed_report_renders_section_6_and_checks():
    path = os.path.join(RESULTS_DIR, "dryrun.json")
    with open(path) as f:
        recs = json.load(f)
    ok = [r for r in recs if "skip" not in r and "error" not in r]
    assert len(ok) == 2 * (34 + 8) and len(recs) == 2 * 48
    text = report.render(RESULTS_DIR)
    assert "## 6. Multi-pod dry-run & roofline (analytic)" in text
    assert report.main(["--check"]) == 0
