"""The port's distributed stepper across processes: one gloo rank per
mesh row, on the CPU (K1's plain version).

Two spawns of ranks (`process.launch`, each under its own deadline) and
one torchrun launch run the port; their results are held here against the
single-controller port on the same layout, against `ops.naive`, and
against one subprocess of the reference on 8 forced host devices (a third
spawn, of two ranks that hang, holds `launch`'s deadline):

- 4 ranks (`_mp_ranks.world4`): `run_distributed` on a 4x2 process mesh
  (four ranks of two devices: z crosses ranks) and on 2x2 over four ranks
  of one device (both axes cross ranks, so the z-y corners travel two
  cross-process hops), the four paper ops and a custom 9-tap op,
  synchronous, overlapped, with a partial final super-step, compressed;
  plan=None and an explicit `MWDPlan`; each carrier's bytes against
  `halo_bytes`; a checkpoint written at world size 4;
- 2 ranks (`_mp_ranks.world2`): `make_process_mesh` of two devices each
  against the reference's `process_grid`, `distributed_vjp`, the
  checkpoint resumed at world size 2, NCCL on one card refused;
- torchrun: `repro_torch.launch.multiprocess` initialized from the
  environment;
- the reference: 7pt-var and 25pt-const through its own
  `run_distributed(plan=None)` on the 4x2 mesh.
"""

import concurrent.futures
import json
import multiprocessing
import os
import random
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import _mp_ranks as R
from repro.launch import mesh as rmesh
from repro_torch.core import stencils as tst
from repro_torch.distributed import halo, process
from repro_torch.distributed import stepper as tstep
from repro_torch.kernels import adjoint as tadj
from repro_torch.kernels import ops as tops

BUDGET = 5e-2           # the reference's compressed-halo budget vs naive
SPAWN_S = 120.0
REF_OPS = ("7pt-var", "25pt-const")
REF_MODES = ("sync", "overlap")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's subprocess, started first so that it runs beside
    the spawns; `reference` waits for it."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, SRC, path, ",".join(REF_OPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


CASES = [(layout, mode, plan, name) for layout in R.LAYOUTS
         for mode in R.MODES for plan in R.PLANS for name in R.NAMES]


def single_controller(layout, mode, plan, name):
    """The single-controller port's run of a case and `ops.naive`'s."""
    spec = R.op(name)
    state, coeffs = R.problem(name, R.grid_of(layout, spec.radius))
    steps, ovl, comp = R.MODES[mode]
    single = tstep.run_distributed(spec, R.single_mesh(layout), state,
                                   coeffs, steps, 2,
                                   plan=R.plan_of(name, plan), overlap=ovl,
                                   compress=comp)
    return single, tops.naive(spec, state, coeffs, steps)


def spawn_both(ckpt):
    """The 4-rank spawn, which writes the checkpoint, then the 2-rank one,
    which resumes it."""
    return (process.launch(R.world4, 4, (ckpt,), timeout_s=SPAWN_S),
            process.launch(R.world2, 2, (ckpt,), timeout_s=SPAWN_S))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference_run):
    """Both spawns' results, and every case's single-controller and naive
    runs, computed here while the ranks run."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    registry = str(tmp_path_factory.mktemp("plans") / "plans.json")
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        mp.setenv("REPRO_TORCH_PLAN_REGISTRY", registry)
        spawned = pool.submit(spawn_both, ckpt)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # the ranks and the reference share the cores
        try:
            single = {case: single_controller(*case) for case in CASES}
        finally:
            torch.set_num_threads(threads)
        four, two = spawned.result()
    return {"four": four, "two": two, "registry": registry,
            "single": single}


@pytest.mark.parametrize("layout,mode,plan,name", CASES)
def test_run_distributed_across_ranks(ranks, layout, mode, plan, name):
    """Every rank gets the same global result; exact runs are bitwise the
    single-controller port's on the same layout and `ops.naive`'s;
    compressed runs are within 1e-5 of the single-controller compressed
    run and within the reference's budget of naive."""
    key = f"{layout}|{mode}|{plan}|{name}"
    assert len({r["digests"][key] for r in ranks["four"]}) == 1
    got = [torch.from_numpy(a) for a in ranks["four"][0]["runs"][key]]
    comp = R.MODES[mode][2]
    single, naive = ranks["single"][layout, mode, plan, name]
    for a, b, c in zip(got, single, naive):
        if comp:
            assert float((a - b).abs().max()) <= 1e-5
            assert float((a - c).abs().max()) < BUDGET
        else:
            assert torch.equal(a, b)
            assert torch.equal(a, c)
    if comp:
        assert not torch.equal(got[0], naive[0])


@pytest.mark.parametrize("layout,name", R.BYTES_CASES)
@pytest.mark.parametrize("compress", [False, True])
def test_carrier_bytes_equal_halo_bytes(ranks, layout, name, compress):
    """What each rank's carrier sends in one super-step is `halo_bytes`
    of its shards over their faces that cross ranks; on 3x3 rank 1 holds
    the one interior shard, whose carrier sends what the dry-run prices
    (`interior_halo_bytes`: all four faces)."""
    spec = R.op(name)
    grid = R.grid_of(layout, spec.radius)
    mesh = R.single_mesh(layout)
    owners = {"4x2": lambda iz, iy: iz, "2x2": lambda iz, iy: 2 * iz + iy,
              "3x3": lambda iz, iy: int((iz, iy) == (1, 1))}[layout]
    shape = mesh.devices.shape
    pd = process.ProcessDevice
    entries = [pd(owners(iz, iy), iy, torch.device("cpu"))
               for iz in range(shape[0]) for iy in range(shape[1])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(process, "process_count", lambda: 4)
        pmesh = type(mesh)(np.array(entries, dtype=object).reshape(shape),
                           mesh.axis_names)
        for rank, out in enumerate(ranks["four"]):
            want = tstep.rank_halo_bytes(spec, pmesh, grid, 2, rank,
                                         compress=compress)
            assert out["bytes"][f"{layout}|{name}|{compress}"] == want
    if layout == "3x3" and not compress:
        assert ranks["four"][1]["bytes"][f"{layout}|{name}|{compress}"] == \
            tstep.interior_halo_bytes(spec, mesh, grid, 2)


def test_process_mesh_rows_equal_reference(ranks):
    stand = [types.SimpleNamespace(process_index=p, id=i)
             for p in (0, 1) for i in (0, 1)]
    random.Random(0).shuffle(stand)
    want = [[(d.process_index, d.id) for d in row]
            for row in rmesh.process_grid(stand)]
    for out in ranks["two"]:
        assert out["rows"] == want


@pytest.mark.parametrize("name", R.VJP_OPS)
def test_distributed_vjp_across_ranks_bitwise(ranks, name):
    spec = tst.SPECS[name]
    grid = R.VJP_GRID[spec.radius]
    state, coeffs = R.problem(name, grid, seed=5)
    w = torch.linspace(-1.0, 1.0, grid[0] * grid[1] * grid[2]).reshape(grid)
    outs, vjp = tadj.distributed_vjp(spec, R.single_mesh("2x2"), state,
                                     coeffs, R.VJP_STEPS, t_block=2)
    want = [outs[0]] + list(vjp((w, torch.zeros_like(w))))
    for out in ranks["two"]:
        for g, h in zip(out[f"vjp|{name}"], want):
            assert (g is None) == (h is None)
            if g is not None:
                assert torch.equal(torch.from_numpy(g), h)


def test_checkpoint_at_world_size_4_resumes_at_2(ranks, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY", ranks["registry"])
    spec = R.op(R.CKPT_OP)
    state, coeffs = R.problem(R.CKPT_OP, R.CKPT_GRID)
    total = sum(R.CKPT_STEPS)
    straight = tstep.run_distributed(spec, R.single_mesh("2x2"), state,
                                     coeffs, total, 2, plan="auto")
    naive = tops.naive(spec, state, coeffs, total)
    for out in ranks["two"]:
        step, got = out["resumed"]
        assert step == R.CKPT_STEPS[0]
        for a, b, c in zip(got, straight, naive):
            assert torch.equal(torch.from_numpy(a), b)
            assert torch.equal(b, c)


def test_nccl_on_one_card_raises_the_ports_error(ranks):
    for out in ranks["two"]:
        assert "needs one card per rank" in out["nccl"]
        assert "ranks 0 and 1 both name cuda:0" in out["nccl"]
        assert "gloo" in out["nccl"]


def test_launch_kills_every_rank_past_its_deadline():
    """Two ranks that hang: `process.launch` raises at its deadline and no
    rank outlives it (a hang must not cost the whole test run)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline of 2 s passed"):
        process.launch(R.hang, 2, timeout_s=2)
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


def test_torchrun_initializes_from_the_environment(tmp_path):
    """Two ranks started by torch.distributed.run: `initialize()` reads
    RANK/WORLD_SIZE and the env:// store; K1 per shard at plan="auto",
    overlapped with a partial final super-step, bitwise against naive."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "REPRO_TORCH_PLAN_REGISTRY": str(tmp_path / "plans.json"),
           "PYTHONPATH": os.pathsep.join(
               [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.multiprocess",
         "--backend", "gloo", "--device", "cpu", "--devices-per-rank", "2",
         "--grid", "16,12,8", "--steps", "5", "--overlap", "--verify"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SPAWN_S)
    finally:
        if proc.poll() is None:     # the deadline: end torchrun's ranks too
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["bitwise"] and line["ranks"] == 2
    assert line["mesh"] == [2, 2]


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax, numpy as np
from repro.core import stencils as st
from repro.distributed import stepper
mesh = jax.make_mesh((4, 2), ("data", "model"))
out = {}
for name in sys.argv[3].split(","):
    spec = st.SPECS[name]
    grid = (24, 16, 8) if spec.radius == 1 else (72, 36, 16)
    state, coeffs = st.make_problem(spec, grid, seed=7)
    for mode in ("sync", "overlap"):
        got = stepper.run_distributed(spec, mesh, state, coeffs, 4,
                                      t_block=2, overlap=mode == "overlap")
        for i in (0, 1):
            out[f"{mode}|{name}|{i}"] = np.asarray(got[i])
np.savez(sys.argv[2], **out)
print("REFERENCE_DONE")
"""


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", REF_OPS)
@pytest.mark.parametrize("mode", REF_MODES)
def test_across_ranks_within_tolerance_of_reference(ranks, reference, name,
                                                    mode):
    """The 4x2 process mesh's plain route against the reference's
    run_distributed(plan=None) on its 4x2 mesh, same inputs."""
    assert R.grid_of("4x2", R.op(name).radius) == (
        (24, 16, 8) if R.op(name).radius == 1 else (72, 36, 16))
    atol, rtol = tst.SPECS[name].tolerance("f32")
    for i, got in enumerate(ranks["four"][0]["runs"][f"4x2|{mode}|none|{name}"]):
        want = reference[f"{mode}|{name}|{i}"].astype(np.float64)
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= atol + rtol * np.abs(want)).all(), float(err.max())


def test_remote_placeholder_and_halo_bytes_faces():
    """A `Remote` slices, expands and pads as a block of its shape; a
    Carrier needs a process group; `halo_bytes` over all four faces is
    the per-shard count."""
    r = halo.Remote.like(3, (4, 6, 8))
    assert r[:, 1:3].shape == (4, 2, 8) and r[:, 1:3].rank == 3
    assert r.new_empty((2, 2, 2)).shape == (2, 2, 2)
    assert r.apply(lambda t: t.sum(0)).shape == (6, 8)
    assert type(halo.wire_for([[torch.zeros(1)]])) is halo.Wire
    with pytest.raises(RuntimeError, match="process group"):
        halo.wire_for([[torch.zeros(1)], [r]])
    assert halo.halo_bytes((4, 6, 8), 2, 4, 1) == halo.halo_bytes(
        (4, 6, 8), 2, 4, 1, faces=halo.FACES)
    assert halo.halo_bytes((4, 6, 8), 2, 4, 1, faces=("z_lo",)) == 2 * 6 * 8 * 4


def test_process_modules_import_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.distributed.process\n"
            "import repro_torch.launch.multiprocess\n"
            "import _mp_ranks\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "print(bad)\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [SRC, os.path.dirname(__file__)])})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
