"""The port's device specs: the H100 file, schema, resolution, fingerprint.

Every test runs behind the autouse fixture below, which clears the port's
spec environment and the --spec override, so the process default is
"h100-sxm" on entry.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro_torch.core import specs as devspecs

H100 = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "specs", "h100-sxm.json")


@pytest.fixture(autouse=True)
def _clean_spec_state(monkeypatch):
    monkeypatch.delenv(devspecs.ENV_SPEC, raising=False)
    monkeypatch.delenv(devspecs.ENV_SPEC_DIR, raising=False)
    devspecs.set_default_spec(None)
    yield
    devspecs.set_default_spec(None)


def _write_spec(path, **changes):
    raw = devspecs.get_spec("h100-sxm").to_dict()
    raw.update(changes)
    path.write_text(json.dumps(raw))
    return str(path)


def test_h100_file_loads_with_the_card_figures():
    spec = devspecs.get_spec("h100-sxm")
    assert spec == devspecs.load_spec_file(H100)
    assert spec.name == "h100-sxm" and spec.source
    # the figures chip_smoke.py priced its bounds with before the spec
    assert spec.hbm_bw == 3.35e12 and spec.peak_flops_f32 == 67e12
    # the kernels' shared-memory limits and K1's largest cluster
    assert spec.smem_block_bytes == 232_448
    assert spec.smem_sm_bytes == 233_472
    assert spec.max_cluster == 16 and spec.n_sm == 132
    assert spec.latency_bytes == pytest.approx(spec.hbm_bw * spec.launch_s)
    assert "latency_bytes" not in spec.to_dict()
    assert devspecs.main([H100]) == 0


def test_spec_dirs_are_the_ports_own():
    dirs = devspecs.spec_dirs()
    assert dirs == [os.path.dirname(os.path.abspath(H100))]
    with pytest.raises(devspecs.SpecError, match="tpu-v5e"):
        devspecs.get_spec("tpu-v5e")        # the reference's specs/ is not read


@pytest.mark.parametrize("mutate, msg", [
    (lambda d: d.pop("hbm_bw"), "missing"),
    (lambda d: d.pop("source"), "source"),
    (lambda d: d.update(turbo=9), "unknown"),
    (lambda d: d.update(vmem_bytes=1), "unknown"),
    (lambda d: d.update(latency_bytes=1.0), "derived"),
    (lambda d: d.update(launch_s=-1.0), "> 0"),
    (lambda d: d.update(cluster_barrier_s=0.0), "> 0"),
    (lambda d: d.update(n_sm="many"), "number"),
    (lambda d: d.update(max_cluster=True), "number"),
    (lambda d: d.update(smem_block_bytes=1.5), "integer"),
    (lambda d: d.update(name=""), "name"),
    # the energy model's and K1's measured constants: required, > 0
    (lambda d: d.pop("static_power_w"), "missing"),
    (lambda d: d.pop("joules_per_hbm_byte"), "missing"),
    (lambda d: d.update(joules_per_flop=0.0), "> 0"),
    (lambda d: d.update(joules_per_hbm_byte=-1e-11), "> 0"),
    (lambda d: d.update(static_power_w=0), "> 0"),
    (lambda d: d.pop("k1_phase_s"), "missing"),
    (lambda d: d.update(k1_cta_phase_s=0.0), "> 0"),
])
def test_schema_rejects(mutate, msg):
    raw = devspecs.get_spec("h100-sxm").to_dict()
    mutate(raw)
    with pytest.raises(devspecs.SpecError, match=msg):
        devspecs.validate_spec_dict(raw)


def test_schema_rejects_non_object_and_roundtrips():
    with pytest.raises(devspecs.SpecError, match="object"):
        devspecs.validate_spec_dict([1, 2, 3])
    spec = devspecs.get_spec("h100-sxm")
    assert devspecs.DeviceSpec(
        **devspecs.validate_spec_dict(spec.to_dict())) == spec


def test_resolution_by_env_and_set_default(tmp_path, monkeypatch):
    assert devspecs.current_spec().name == devspecs.DEFAULT_SPEC_NAME
    slow = _write_spec(tmp_path / "slow-card.json", name="slow-card",
                       hbm_bw=1e12)
    assert devspecs.set_default_spec(slow).name == "slow-card"
    assert devspecs.current_spec().hbm_bw == 1e12
    # the env var outranks the CLI override, by name through the spec dir
    _write_spec(tmp_path / "env-card.json", name="env-card")
    monkeypatch.setenv(devspecs.ENV_SPEC_DIR, str(tmp_path))
    monkeypatch.setenv(devspecs.ENV_SPEC, "env-card")
    assert devspecs.current_spec().name == "env-card"
    monkeypatch.delenv(devspecs.ENV_SPEC)
    with pytest.raises(devspecs.SpecError):
        devspecs.set_default_spec("no-such-card")
    assert devspecs.current_spec().name == "slow-card"   # not committed
    assert devspecs.get_spec("h100-sxm") is devspecs.get_spec("h100-sxm")


def test_cli_validates_and_rejects(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "bad", "source": "x"}))
    assert devspecs.main([H100, str(bad)]) == 1
    out = capsys.readouterr().out
    assert "ok " in out and "FAIL" in out


def test_fingerprint_stable_and_sensitive(tmp_path):
    spec = devspecs.get_spec("h100-sxm")
    assert devspecs.fingerprint() == devspecs.fingerprint(spec)
    assert devspecs.fingerprint(spec) == devspecs.fingerprint(spec)
    for field, value in (("hbm_bw", 2 * spec.hbm_bw),
                         ("launch_s", 2 * spec.launch_s),
                         ("smem_block_bytes", 1024)):
        other = dataclasses.replace(spec, **{field: value})
        assert devspecs.fingerprint(other) != devspecs.fingerprint(spec)
    # an edited spec file reloads and changes the fingerprint
    path = tmp_path / "edited.json"
    shutil.copy(H100, path)
    before = devspecs.fingerprint(devspecs.get_spec(str(path)))
    raw = json.loads(path.read_text())
    raw["cluster_barrier_s"] *= 2
    path.write_text(json.dumps(raw))
    stamp = os.stat(path).st_mtime_ns + 1_000_000
    os.utime(path, ns=(stamp, stamp))
    assert devspecs.fingerprint(devspecs.get_spec(str(path))) != before


def test_modules_import_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch.core.specs, repro_torch.core.models\n"
            "import repro_torch.core.autotune, repro_torch.core.registry\n"
            "import repro_torch.core.traffic, repro_torch.launch.tune\n"
            "import repro_torch.kernels.ops, repro_torch.launch.serve\n"
            "import repro_torch.distributed.stepper\n"
            "import repro_torch.distributed.halo\n"
            "import repro_torch.distributed.compression\n"
            "import repro_torch.distributed.checkpoint\n"
            "import repro_torch.distributed.elastic\n"
            "import repro_torch.launch.mesh, repro_torch.launch.scaling_gate\n"
            "import repro_torch.launch.sweep, repro_torch.launch.report\n"
            "import repro_torch.kernels.adjoint\n"
            "import repro_torch.core.listings, repro_torch.benchmarks.run\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.custom_stencil\n"
            "import repro_torch.examples.heat3d_train\n"
            "import repro_torch.examples.distributed_stencil\n"
            "import repro_torch.configs, repro_torch.models.lm\n"
            "import repro_torch.data.pipeline, repro_torch.launch.train\n"
            "import repro_torch.training.steps\n"
            "import repro_torch.examples.train_lm\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "print(bad)\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
