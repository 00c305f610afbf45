"""``BENCHMARK.json`` against the benchmark's contract, and the last line
a run prints."""
import json
import re

import pytest
from conftest import ROOT, small_config

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_limits(manifest):
    assert set(manifest) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _under_paths(manifest, f):
    return any(f.startswith(p.rstrip("/") + "/") for p in manifest["paths"])


def test_configs(manifest):
    cfgs = manifest["configs"]
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert _under_paths(manifest, c["file"]) and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    names = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert len({w["name"] for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)


def test_metrics(manifest):
    e2e, per = manifest["end_to_end"], manifest["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    cells = {w["name"] for w in manifest["workloads"]}
    e2e_names = {m["name"] for m in e2e}
    assert "setup_s" in e2e_names
    seen = set()
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e_names and _line(m["layer"])
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for w in cells:
        assert len(harness.cell_metrics(manifest, w, False)) >= 2
        assert harness.cell_metrics(manifest, w, True)


@pytest.mark.parametrize("trace_on", [False, True])
def test_last_line_schema(manifest, trace_on):
    cfg = small_config("hpcg-40", rows=800)
    traffic = harness.load_json(ROOT / "perfbench" / "traffic" / "auto.json")
    res = harness.run_cell(
        cfg, traffic,
        harness.cell_metrics(manifest, "hpcg-40.auto", trace_on),
        seed=2 ** 31 + 3, seconds=1.0, trace_on=trace_on, device="cpu")
    line = json.loads(json.dumps(res))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in
            harness.cell_metrics(manifest, "hpcg-40.auto", trace_on)}
    got = set(line["metrics"])
    if trace_on:
        # no device on the CPU: the trace's readers find nothing, and a
        # percentile needs two calls
        missing = {"kernels_roofline", "idle_pct"}
        if line["attempted"] < 2:
            missing.add("call_p95_ms")
        assert got == want - missing
    else:
        assert got == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
