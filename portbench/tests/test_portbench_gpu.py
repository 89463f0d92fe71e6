"""On the card: each cell of BENCHMARK.json runs once, briefly, traced and
not, and prints the contract's line with ``correct`` true.  Skips without
a CUDA device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import catalog

REPO = os.path.dirname(catalog.ROOT)
CELLS = [w["name"] for w in catalog.benchmark(REPO)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark runs on the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "10", "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
