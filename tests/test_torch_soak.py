"""The port's soak and its SLO gate vs the reference's.

`repro_torch.launch.soak_report.verdict` and its CLI are held to
``benchmarks/soak_report.py`` on the same reports; the soak mix runs on the
CPU with its correctness checks (every response equal to its own
`ops.mwd` by ``torch.equal``, no request dropped) and no wall-clock
assertion: the throughput contest is a measurement for the card.
"""

import ast
import json
from pathlib import Path

import pytest

from benchmarks import soak_report as rgate
from repro.core import padding as rpad
from repro_torch.launch import soak
from repro_torch.launch import soak_report as tgate

GOOD = {"p99_ms": 12.0, "dropped": 0, "bitwise_ok": True,
        "throughput_ratio": 1.8}
CI = dict(max_p99_ms=2500.0, max_dropped=0, min_throughput_ratio=1.0)


def reference_report_keys():
    """The keys of the report dict literal in benchmarks/run.py's soak()."""
    src = Path(__file__).resolve().parents[1] / "benchmarks" / "run.py"
    fn = next(n for n in ast.parse(src.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "soak")
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["report"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no report dict in benchmarks/run.py soak()")


@pytest.mark.parametrize("patch", [
    {}, {"p99_ms": 3000.0}, {"p99_ms": None}, {"dropped": 3},
    {"bitwise_ok": False}, {"throughput_ratio": 0.4},
    {"dropped": 1, "throughput_ratio": 0.9}])
def test_verdict_equals_reference(patch):
    report = dict(GOOD)
    for k, v in patch.items():
        if v is None:
            del report[k]
        else:
            report[k] = v
    got, want = tgate.verdict(report, **CI), rgate.verdict(report, **CI)
    assert got == want
    assert len(got) == len(patch)


@pytest.mark.parametrize("argv,code", [
    (["--max-p99-ms", "100"], 0),
    (["--max-p99-ms", "5"], 1),
    (["--max-p99-ms", "100", "--min-throughput-ratio", "2.0"], 1)])
def test_cli_lines_and_exit_codes_equal_reference(tmp_path, capsys, argv,
                                                  code):
    path = str(tmp_path / "soak.json")
    Path(path).write_text(json.dumps(dict(GOOD, op="7pt-var",
                                          batch_sizes=[4, 4])))
    assert rgate.main([path] + argv) == code
    want = capsys.readouterr().out
    assert tgate.main([path] + argv) == code
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1] == ("SOAK GATE: PASS" if code == 0
                                    else "SOAK GATE: FAIL")


def test_soak_mix_on_the_cpu(tmp_path):
    events = str(tmp_path / "soak.json.events.jsonl")
    report, problems, launches = soak.run_mix("cpu", events)
    assert launches == 0                # the CPU runs K1's plain version
    assert report["bitwise_ok"] and report["dropped"] == 0
    assert report["served"] == report["n_requests"] == len(problems) == 24
    assert sum(report["batch_sizes"]) == 24
    assert max(report["batch_sizes"]) <= soak.MAX_BATCH
    lad = rpad.parse_ladder(soak.LADDER)
    classes = {}
    for i in range(24):
        cls = str(lad.padded_shape(soak.GRIDS[i % 2]))
        classes[cls] = classes.get(cls, 0) + 1
    assert report["classes"] == classes and len(classes) == 2
    assert report["padding_waste"] > 0.0
    assert report["p99_ms"] >= report["p50_ms"] > 0.0
    lines = Path(events).read_text().splitlines()
    assert json.loads(lines[-1])["event"] == "summary"
    keys = set(report) | {"throughput_ratio", "t_seq_s", "t_bat_s", "events"}
    assert keys == reference_report_keys()


def test_soak_writes_its_report_where_the_env_says(tmp_path, monkeypatch,
                                                   capsys):
    path = tmp_path / "out" / "soak.json"
    monkeypatch.setenv(soak.ENV_REPORT, str(path))
    monkeypatch.setattr(soak, "contest", lambda problems: (2.0, 1.0))
    assert soak.main(["--device", "cpu"]) == 0
    report = json.loads(path.read_text())
    assert set(report) == reference_report_keys()
    assert report["throughput_ratio"] == 2.0
    assert report["events"] == str(path) + ".events.jsonl"
    assert tgate.main([str(path), "--max-p99-ms", "2500", "--max-dropped",
                       "0", "--min-throughput-ratio", "1.0"]) == 0
    assert "SOAK GATE: PASS" in capsys.readouterr().out


def test_soak_fails_when_batching_loses(tmp_path, monkeypatch):
    monkeypatch.setattr(soak, "contest", lambda problems: (1.0, 2.0))
    path = tmp_path / "soak.json"
    with pytest.raises(soak.SoakFailed, match="below sequential"):
        soak.run_soak("cpu", str(path))
    assert not path.exists()
    monkeypatch.delenv(soak.ENV_REPORT, raising=False)
    assert soak.report_path() == soak.DEFAULT_REPORT
    assert soak.DEFAULT_REPORT.startswith(".repro_torch_cache")
    assert soak.build_parser().parse_args([]).device == "cuda"
