"""The distributed stepper's pure parts against the reference's, in process.

`partition_geometry`, `overlap_work`, `validate_super_step` (its messages
too), `overlap_feasible`, `local_extended_shape`, `cap_plan_d_w`,
`halo_bytes`, `init_halo_error`'s shapes, `plan_mesh`, `process_grid` and
`models.super_step_time`: equal to `repro`'s on the same arguments
(super_step_time to 1e-12). Meshes are stand-ins with the reference's
``axis_names`` and ``shape``; the port's `GridSharding` reads nothing else
for these.
"""

import types

import pytest

from repro.core import models as rmodels
from repro.core import stencils as rst
from repro.core.mwd import MWDPlan as RPlan
from repro.distributed import elastic as relastic
from repro.distributed import halo as rhalo
from repro.distributed import stepper as rstep
from repro.launch import mesh as rmesh
from repro_torch.core import models as tmodels
from repro_torch.core import stencils as tst
from repro_torch.core.mwd import MWDPlan as TPlan
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import halo as thalo
from repro_torch.distributed import stepper as tstep
from repro_torch.launch import mesh as tmesh

NAMES = list(tst.SPECS)
SHAPES = [(12, 10, 8), (16, 16, 8), (24, 36, 16), (7, 9, 5)]


def fake_mesh(**axes):
    return types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))


MESHES = [fake_mesh(data=2, model=2), fake_mesh(data=4, model=2),
          fake_mesh(pod=2, data=2, model=2), fake_mesh(data=1, model=8),
          fake_mesh(data=1, model=1)]


def zones(part):
    return [(z.name, z.z, z.y, z.kept, z.origin) for z in part.zones]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("split_z,split_y", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_partition_geometry_equals_reference(shape, g, split_z, split_y):
    r = rstep.partition_geometry(shape, g, split_z, split_y)
    t = tstep.partition_geometry(shape, g, split_z, split_y)
    assert zones(t) == zones(r)
    for f in ("local_shape", "g", "split_z", "split_y", "interior_kept",
              "interior_origin"):
        assert getattr(t, f) == getattr(r, f), f


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("r,t_block", [(1, 1), (1, 2), (1, 3), (4, 2)])
def test_overlap_work_equals_reference(shape, r, t_block):
    for sz in (True, False):
        for sy in (True, False):
            assert tstep.overlap_work(shape, r, t_block, sz, sy) == \
                rstep.overlap_work(shape, r, t_block, sz, sy)


def _outcome(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m.shape.values())))
def test_validate_super_step_equals_reference(name, mesh):
    rspec, tspec = rst.SPECS[name], tst.SPECS[name]
    for grid in ((7, 8, 8), (4, 8, 8), (8, 8, 8), (16, 16, 8), (32, 64, 8),
                 (72, 36, 16)):
        for t_block in (1, 2, 4):
            for overlap in (False, True):
                want = _outcome(lambda: rstep.validate_super_step(
                    rspec, mesh, grid, t_block, overlap=overlap))
                got = _outcome(lambda: tstep.validate_super_step(
                    tspec, mesh, grid, t_block, overlap=overlap))
                assert got == want, (grid, t_block, overlap)
            assert tstep.overlap_feasible(tspec, mesh, grid, t_block) == \
                rstep.overlap_feasible(rspec, mesh, grid, t_block)
            assert tstep.local_extended_shape(tspec, mesh, grid, t_block) \
                == rstep.local_extended_shape(rspec, mesh, grid, t_block)


@pytest.mark.parametrize("name", NAMES)
def test_cap_plan_d_w_equals_reference(name):
    rspec, tspec = rst.SPECS[name], tst.SPECS[name]
    r = tspec.radius
    for d_w in (2 * r, 4 * r, 8, 16, 32, 64):
        if d_w % (2 * r):
            continue
        for n_f in (1, 2, 3, 4, 8):
            for ny in (2, 5, 6, 9, 24, 130, 260):
                want = rstep.cap_plan_d_w(rspec, RPlan(d_w=d_w, n_f=n_f), ny)
                got = tstep.cap_plan_d_w(tspec, TPlan(d_w=d_w, n_f=n_f), ny)
                assert (got.d_w, got.n_f) == (want.d_w, want.n_f)


@pytest.mark.parametrize("compress", [False, True])
def test_halo_bytes_equals_reference(compress):
    for shape in SHAPES + [(256, 256, 512)]:
        for depth in (1, 2, 8):
            for word in (2, 4, 8):
                for streams in (1, 2):
                    assert thalo.halo_bytes(shape, depth, word, streams,
                                            compress) == \
                        rhalo.halo_bytes(shape, depth, word, streams,
                                         compress)


@pytest.mark.parametrize("shape", [(8, 6, 5), (3, 8, 6, 5)])
@pytest.mark.parametrize("depth", [1, 2])
def test_init_halo_error_shapes_equal_reference(shape, depth):
    want = rhalo.init_halo_error(shape, depth)
    got = thalo.init_halo_error(shape, depth)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype) == "torch.float32"


def test_plan_mesh_equals_reference():
    for n in list(range(1, 70)) + [128, 255, 256, 300, 511, 512, 1024]:
        assert telastic.plan_mesh(n) == relastic.plan_mesh(n)


def _dev(proc, dev_id):
    return types.SimpleNamespace(process_index=proc, id=dev_id)


@pytest.mark.parametrize("devs", [
    [_dev(1, 5), _dev(0, 1), _dev(1, 4), _dev(0, 0)],
    [_dev(0, 3), _dev(0, 1), _dev(0, 2)],
    [_dev(2, 0), _dev(0, 1), _dev(1, 2)],
])
def test_process_grid_equals_reference(devs):
    def ids(rows):
        return [[(d.process_index, d.id) for d in row] for row in rows]
    assert ids(tmesh.process_grid(devs)) == ids(rmesh.process_grid(devs))


def test_process_grid_rejects_as_reference():
    for devs in ([_dev(0, 0), _dev(0, 1), _dev(1, 2)], []):
        with pytest.raises(ValueError) as want:
            rmesh.process_grid(devs)
        with pytest.raises(ValueError) as got:
            tmesh.process_grid(devs)
        assert str(got.value).split(" — ")[0] == \
            str(want.value).split(" — ")[0]


def test_process_mesh_degenerates_to_one_row():
    import torch
    cpu = torch.device("cpu")
    m = tmesh.make_process_mesh([cpu, cpu, cpu])
    assert m.shape == {"data": 1, "model": 3}
    assert all(d == cpu for d in m.devices.flat)
    stand = [types.SimpleNamespace(process_index=p, id=i, device=cpu)
             for p in (1, 0) for i in (0, 1)]
    assert tmesh.make_process_mesh(stand).shape == {"data": 2, "model": 2}


@pytest.mark.parametrize("terms", [(5.0, 1.0, 3.0), (2.0, 0.5, 9.0),
                                   (1e-3, 2e-4, 1e-3), (0.0, 0.0, 0.0)])
def test_super_step_time_equals_reference(terms):
    for overlap in (False, True):
        got = tmodels.super_step_time(*terms, overlap=overlap)
        want = rmodels.super_step_time(*terms, overlap=overlap)
        assert abs(got - want) <= 1e-12


def test_grid_sharding_devices_and_round_trip():
    import torch
    cpu = torch.device("cpu")
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                           devices=[cpu] * 8)
    gs = tstep.GridSharding(mesh)
    assert gs.counts() == (4, 2) and gs.z_axes == ("pod", "data")
    x = torch.arange(8 * 6 * 3, dtype=torch.float32).reshape(8, 6, 3)
    grid = gs.shard(x)
    assert [[tuple(b.shape) for b in row] for row in grid] == \
        [[(2, 3, 3)] * 2] * 4
    assert torch.equal(gs.gather(grid), x)
    assert torch.equal(grid[1][1], x[2:4, 3:6])
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                        devices=[cpu] * 4)
    with pytest.raises(ValueError, match="devices are healthy"):
        telastic.build_mesh(5, [cpu] * 4)
    assert telastic.build_mesh(2, [cpu] * 4).shape == {"data": 1, "model": 2}
