"""On the card only (marker ``cuda``; skips elsewhere): each cell of
BENCHMARK.json run once by its entry, as the check runs it, short."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(cuda_card, name):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          str(2**31 + 12345), "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    names = {m["name"] for m in spec.cell(name).per_layer}
    assert set(result["metrics"]) == names
