"""A short run of every cell on the card (``-m cuda``; skips without one)."""
import json
import subprocess
import sys

import pytest
from conftest import ROOT

from perfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    for w in manifest["workloads"]:
        res = subprocess.run(
            [sys.executable, "-m", "perfbench.run", "--workload", w["name"],
             "--seed", "2147483701", "--seconds", "2", "--trace",
             str(trace)], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
        want = {m["name"] for m in harness.cell_metrics(manifest, w["name"],
                                                         bool(trace))}
        assert set(line["metrics"]) == want
