"""On the card: one short run of each cell through `run.py`, its result
line read back (``-m gpu``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from girih_bench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "girih_bench/run.py", "--workload", name,
         "--seed", "4000000123", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check gap ")
