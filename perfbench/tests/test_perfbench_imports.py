"""After a dry pass of the harness no module of JAX or of the JAX package
is loaded (top-level names compared whole: ``repro_torch`` is not
``repro``)."""
import json
import os
import subprocess
import sys

from conftest import ROOT

from perfbench import harness

DRY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness
sys.path.insert(0, {tests!r})
from conftest import small_config
m = harness.load_json(harness.ROOT / "BENCHMARK.json")
for w in [c["name"] for c in m["workloads"]]:
    cell, cfg, traffic = harness.find_cell(m, w)
    res = harness.run_cell(small_config(cell["config"], rows=800),
                           traffic, harness.cell_metrics(m, w, True),
                           seed=1, seconds=0.2, trace_on=True,
                           device="cpu")
    assert res["correct"], res
print(json.dumps({{"bad": harness.forbidden_modules(),
                  "top": sorted({{k.split(".")[0] for k in sys.modules}})}}))
"""


def test_no_jax_after_a_dry_pass():
    code = DRY.format(root=str(ROOT), src=str(ROOT / "src"),
                      tests=str(ROOT / "perfbench" / "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["top"])


def test_names_are_compared_whole(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_fake.x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib_fake", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    assert "repro" in harness.forbidden_modules()
