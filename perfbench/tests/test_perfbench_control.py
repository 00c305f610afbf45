"""The comparison's control and its planted faults, at a CPU size.

The control is the reference computed in bfloat16, the precision below
the configurations' float32, put in the program's place: it has to come
out not correct.  Then the harness is driven with the timed path broken
underneath, once for each fault a SpGEMM cell can have, and has to report
``correct`` false."""
import numpy as np
import pytest
from conftest import ROOT, small_config

from perfbench import compare, generate, harness
from perfbench.reference import spgemm as ref
from repro_torch.core import dispatch


@pytest.mark.parametrize("name", ["hpcg-40", "enron-standin"])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 5, 77])
def test_bf16_control_fails(name, seed):
    cfg = small_config(name, rows=3000)
    lane = generate.draw(cfg, seed)
    want = ref.spgemm(lane, lane, cfg["cols"])
    numbers = compare.compare(ref.spgemm_bf16(lane, lane, cfg["cols"]),
                              want, cfg["cols"])
    assert not compare.passes(numbers)
    assert numbers["value_err"] > compare.LIMITS["value_err"]
    # the float64 reference itself passes, as does its float32 rounding
    own = want[:2] + (want[2].astype(np.float32),)
    assert compare.passes(compare.compare(own, want, cfg["cols"]))


def _run(monkeypatch, workload, fake=None):
    m = harness.load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = harness.find_cell(m, workload)
    if fake is not None:
        orig = dispatch.execute
        monkeypatch.setattr(dispatch, "execute",
                            lambda *a, **k: fake(orig(*a, **k)))
    return harness.run_cell(
        small_config(cell["config"], rows=800), traffic,
        harness.cell_metrics(m, workload, False), seed=3, seconds=0.3,
        trace_on=False, device="cpu")


def test_sound_runs_are_correct(monkeypatch):
    m = harness.load_json(ROOT / "BENCHMARK.json")
    for w in [c["name"] for c in m["workloads"]]:
        assert _run(monkeypatch, w)["correct"], w


def _value_altered(res):
    out, stats = res
    out.data[out.indptr[-1] // 2] += 0.5
    return out, stats


def _column_altered(res):
    out, stats = res
    i = int(out.indptr[-1]) // 3
    out.indices[i] = (out.indices[i] + 1) % out.n_cols
    return out, stats


def test_an_altered_value_is_not_correct(monkeypatch):
    res = _run(monkeypatch, "hpcg-40.auto", _value_altered)
    assert not res["correct"]
    assert res["checks"]["value_err"]["value"] > \
        res["checks"]["value_err"]["limit"]


def test_an_altered_column_is_not_correct(monkeypatch):
    res = _run(monkeypatch, "enron-standin.auto", _column_altered)
    assert not res["correct"]
    assert res["checks"]["structure"]["value"] > 0


def test_an_answer_that_never_comes_is_not_correct(monkeypatch):
    calls = []

    def fail_in_window(res):   # the two warm-up calls land
        calls.append(1)
        if len(calls) > 2:
            raise RuntimeError("lost")
        return res
    res = _run(monkeypatch, "hpcg-40.auto", fail_in_window)
    assert not res["correct"] and res["failed"] == res["attempted"] > 0


def test_an_operand_returned_unchanged_is_not_correct(monkeypatch):
    orig = dispatch.execute

    def echo(p, A, B, **kw):
        return A, orig(p, A, B, **kw)[1]
    monkeypatch.setattr(dispatch, "execute", echo)
    assert not _run(monkeypatch, "hpcg-40.auto")["correct"]
