"""The port's fault injection, quarantine and resilient execute path, on
the CPU.

``repro_torch.runtime.faultinject`` must fire on the same call indices
as ``repro.runtime.faultinject`` for the same specs and seed; the cases
of ``tests/test_resilience.py`` on the autotune quarantine and on
``execute_resilient`` are ported with the port's ladder, whose first
rung on the CPU is ``spz-fused/torch`` where the reference's is
``spz-fused/xla``.  On a card the ladder is ``spz-fused/cuda`` then
``esc``: neither the plain tier nor the host stands in for a kernel, and
a kernel that fails to build or launch raises at once.
Every case runs on a ``tmp_path`` cache with ``device="cpu"`` and a
virtual clock or no sleep.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import faultinject as ref_fi
from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm_engines as sg
from repro_torch.core.formats import batch_csr, csr_to_numpy, random_sparse
from repro_torch.kernels import _build
from repro_torch.kernels import backend as kb
from repro_torch.runtime import faultinject as fi

torch.set_num_threads(2)


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


def _mat(n=48, density=0.02, seed=0, pattern="uniform"):
    return random_sparse(n, n, density, seed=seed, pattern=pattern)


def _dense(csr):
    return csr.to_dense().numpy().astype(np.float64)


def _nosleep_policy(**kw):
    kw.setdefault("sleep", lambda s: None)
    return dp.RetryPolicy(**kw)


# ---------------------------------------------------------------------------
# the fault-injection harness, against the reference's
# ---------------------------------------------------------------------------

def _firing(mod, specs, calls, seed):
    """Which of ``calls`` ((site, ctx) pairs) raise, and the injector's
    event log, under ``mod.injected(*specs, seed=seed)``."""
    fired = []
    with mod.injected(*specs, seed=seed) as inj:
        for site, ctx in calls:
            try:
                mod.fire(site, **ctx)
                fired.append(0)
            except mod.InjectedFault:
                fired.append(1)
    return fired, inj.events


def _spec_sets(mod):
    return [
        [mod.FaultSpec(site="dispatch.execute", rate=0.3)],
        [mod.FaultSpec(site="dispatch.execute", rate=0.5, max_fires=4,
                       match={"engine": "spz"}),
         mod.FaultSpec(site="dispatch.measure", rate=0.2)],
        [mod.FaultSpec(site="dispatch.execute", kind="hang", rate=0.4),
         mod.FaultSpec(site="dispatch.execute", rate=0.25)],
    ]


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("case", range(3))
def test_firing_matches_reference(case, seed):
    rng = np.random.default_rng(seed + 100)
    sites = ["dispatch.execute", "dispatch.measure", "autotune.flush"]
    engines = ["spz", "esc", "spz-fused"]
    calls = [(sites[int(rng.integers(3))],
              {"engine": engines[int(rng.integers(3))]}) for _ in range(60)]
    ref_specs = _spec_sets(ref_fi)[case]
    mine_specs = _spec_sets(fi)[case]
    for s in ref_specs + mine_specs:
        if s.kind == "hang":
            s.delay_s = 0.0
    want = _firing(ref_fi, ref_specs, calls, seed)
    got = _firing(fi, mine_specs, calls, seed)
    assert got == want
    assert [s.fires for s in mine_specs] == [s.fires for s in ref_specs]
    assert sum(got[0]) > 0


def test_hooks_are_noops_when_disabled():
    assert fi.active() is None
    fi.fire("dispatch.execute", engine="esc")
    m = _mat(seed=1)
    assert fi.corrupt("dispatch.execute", m) is m


def test_match_filter_max_fires_and_hang():
    spec = fi.FaultSpec(site="s", match={"device": 1}, max_fires=1)
    with fi.injected(spec) as inj:
        fi.fire("s", device=0)
        with pytest.raises(fi.InjectedFault):
            fi.fire("s", device=1)
        fi.fire("s", device=1)
        assert spec.fires == 1 and len(inj.events) == 1
        assert inj.events[0] == {"site": "s", "kind": "raise", "call": 2,
                                 "device": 1}
    naps = []
    with fi.injected(fi.FaultSpec(site="s", kind="hang", delay_s=2.5),
                     sleep=naps.append) as inj:
        inj.fire("s")
    assert naps == [2.5] and fi.active() is None


def test_corrupt_nan_and_garbage_are_detectable():
    m = _mat(seed=2)
    out = sg.spgemm_scl_array(m, m)
    with fi.injected(fi.FaultSpec(site="dispatch.execute", kind="nan")):
        bad = fi.corrupt("dispatch.execute", out)
    assert bad.data.device == out.data.device
    with pytest.raises(dp.CorruptOutput, match="non-finite"):
        dp.check_result(bad)
    with fi.injected(fi.FaultSpec(site="dispatch.execute", kind="garbage")):
        bad = fi.corrupt("dispatch.execute", (out, "stats"))
    assert bad[1] == "stats"
    with pytest.raises(dp.CorruptOutput, match="out of range"):
        dp.check_result(bad[0])
    dp.check_result(out)  # the pristine result still screens clean
    # a corrupted batch (list of lanes, None for padding) stays a list
    with fi.injected(fi.FaultSpec(site="x", kind="nan")):
        lanes = fi.corrupt("x", [out, None])
    assert lanes[1] is None and torch.isnan(lanes[0].data).all()


def test_check_result_reads_only_the_valid_entries():
    """Padding past nnz is not screened: EMPTY columns and zeros there
    are the layout, not corruption."""
    m = _mat(seed=4)
    out = sg.spgemm_scl_array(m, m)
    nnz = int(out.indptr[-1])
    padded = dp.CSR(out.indptr, torch.cat([out.indices, torch.full(
        (5,), -1, dtype=torch.int32)]), torch.cat([out.data, torch.full(
            (5,), float("nan"))]), out.shape)
    assert nnz > 0 and padded.nnz_cap == out.nnz_cap + 5
    dp.check_result(padded)


def test_injected_execute_fault_reaches_dispatch(cache):
    m = _mat(seed=3)
    p = dp.plan(m, m, engine="esc", device="cpu", cache=cache)
    with fi.injected(fi.FaultSpec(site="dispatch.execute",
                                  match={"engine": "esc"})) as inj:
        with pytest.raises(fi.InjectedFault):
            dp.execute(p, m, m)
        # execute never falls back: the fault reaches the caller
        with pytest.raises(fi.InjectedFault):
            dp.spgemm(m, m, engine="esc", device="cpu")
    assert [e["engine"] for e in inj.events] == ["esc", "esc"]


# ---------------------------------------------------------------------------
# autotune quarantine
# ---------------------------------------------------------------------------

def test_quarantine_roundtrip_and_version_bump(cache):
    key = "48x48@7*48x48@7"
    v0 = cache.version
    cache.put(key, "esc", "autotune")
    cache.quarantine(key, "esc", None, reason="kernel crashed")
    assert cache.is_quarantined(key, "esc")
    assert cache.is_quarantined(key, "esc", "cuda")
    assert not cache.is_quarantined(key, "spz-fused", "torch")
    assert ("esc", None) in cache.quarantined(key)
    assert cache.get(key) is None
    assert cache.version > v0
    assert dp.AutotuneCache(cache.path).is_quarantined(key, "esc")


def test_quarantine_ttl_and_strikes(tmp_path):
    clock = VirtualClock()
    c = dp.AutotuneCache(str(tmp_path / "a.json"), quarantine_ttl_s=10.0,
                         clock=clock)
    c.quarantine("k", "spz", "cuda")
    assert c.is_quarantined("k", "spz", "cuda")
    clock.advance(10.0)
    assert not c.is_quarantined("k", "spz", "cuda")  # re-admitted
    c.quarantine("k", "spz", "cuda")  # second strike: twice the TTL
    clock.advance(15.0)
    assert c.is_quarantined("k", "spz", "cuda")
    clock.advance(5.0)
    assert not c.is_quarantined("k", "spz", "cuda")


def test_v1_quarantine_is_stamped_on_load(tmp_path):
    import json
    p = tmp_path / "a.json"
    p.write_text(json.dumps({"!quarantine:k": {"combos": ["esc|"]}}))
    clock = VirtualClock()
    clock.advance(100.0)
    c = dp.AutotuneCache(str(p), clock=clock, quarantine_ttl_s=5.0)
    assert c.is_quarantined("k", "esc")
    assert c.entries()["!quarantine:k"]["ts"] == {"esc|": 100.0}
    assert c.loaded_schema_version == 1
    clock.advance(5.0)
    assert not c.is_quarantined("k", "esc")


def test_quarantine_merges_across_processes(cache):
    other = dp.AutotuneCache(cache.path)
    cache.quarantine("k", "esc", None)
    other.quarantine("k", "spz-fused", "torch")
    merged = dp.AutotuneCache(cache.path)
    assert merged.is_quarantined("k", "esc")
    assert merged.is_quarantined("k", "spz-fused", "torch")


def test_refresh_pulls_entries_flushed_by_another_process(cache):
    other = dp.AutotuneCache(cache.path)
    cache.put("mine", "esc", "heuristic")
    v0 = cache.version
    other.put("theirs", "spz-fused", "autotune")
    other.quarantine("poisoned", "esc", None)
    assert cache.get("theirs") is None
    assert cache.refresh() is True
    assert cache.get("theirs")["engine"] == "spz-fused"
    assert cache.is_quarantined("poisoned", "esc")
    assert cache.version > v0
    v1 = cache.version
    assert cache.refresh() is False
    assert cache.version == v1


def test_plan_miss_pulls_quarantine_pushed_by_sibling(cache, tmp_path):
    m = _mat(seed=21)
    probe = dp.plan(m, m, device="cpu",
                    cache=dp.AutotuneCache(str(tmp_path / "probe.json")))
    assert len(cache) == 0
    sibling = dp.AutotuneCache(cache.path)
    sibling.quarantine(probe.cache_key, probe.engine, probe.backend,
                       reason="crashed in sibling")
    p = dp.plan(m, m, device="cpu", cache=cache)
    assert (p.engine, p.backend) != (probe.engine, probe.backend)
    assert p.rule == "quarantine-fallback"


def test_flush_lock_timeout_skips_never_stalls(cache):
    """A hung — not dead — holder of the cache's file lock costs a
    skipped flush, never a stalled process."""
    holder = dp.AutotuneCache(cache.path)
    holding = threading.Event()
    release = threading.Event()

    def hold_and_hang(_delay):
        holding.set()
        release.wait(timeout=30.0)

    def run_holder():
        with fi.injected(fi.FaultSpec(site="autotune.flush", kind="hang",
                                      delay_s=1.0, max_fires=1),
                         sleep=hold_and_hang):
            holder.put("held", "esc", "heuristic")

    t = threading.Thread(target=run_holder, daemon=True)
    t.start()
    assert holding.wait(timeout=10.0)
    contender = dp.AutotuneCache(cache.path, lock_timeout_s=0.2)
    t0 = time.monotonic()
    contender.put("contended", "spz-fused", "heuristic")
    assert time.monotonic() - t0 < 5.0
    assert contender.get("contended") is not None
    assert dp.AutotuneCache(cache.path).get("contended") is None
    release.set()
    t.join(timeout=30.0)
    assert not t.is_alive()
    contender.put("contended2", "esc", "heuristic")
    merged = dp.AutotuneCache(cache.path)
    for k in ("contended", "contended2", "held"):
        assert merged.get(k) is not None, k


def test_autotune_sweep_survives_crashing_engine(cache):
    """A candidate that raises mid-sweep is quarantined and the sweep
    finishes on the healthy engines."""
    def crashy(A, B, **kw):
        raise RuntimeError("synthetic kernel crash")
    dp.register_engine("crashy", crashy, measure=True,
                       description="always raises (test engine)")
    try:
        m = _mat(seed=7)
        p = dp.plan(m, m, autotune=True, device="cpu", cache=cache)
        assert p.source == "autotune" and p.engine != "crashy"
        assert cache.is_quarantined(p.cache_key, "crashy")
        np.testing.assert_allclose(_dense(dp.execute(p, m, m)),
                                   _dense(sg.spgemm_scl_array(m, m)),
                                   rtol=1e-4, atol=1e-4)
    finally:
        dp._REGISTRY.pop("crashy", None)


def test_plan_routes_around_quarantined_selection(cache):
    m = _mat(seed=8)
    p0 = dp.plan(m, m, device="cpu", cache=cache)
    cache.quarantine(p0.cache_key, p0.engine, p0.backend,
                     reason="poisoned by test")
    p1 = dp.plan(m, m, device="cpu", cache=cache)
    assert (p1.engine, p1.backend) != (p0.engine, p0.backend)
    assert p1.rule == "quarantine-fallback"


def test_measure_fault_site_quarantines_mid_sweep(cache):
    m = _mat(seed=9)
    with fi.injected(fi.FaultSpec(site="dispatch.measure",
                                  match={"engine": "esc"})):
        p = dp.plan(m, m, autotune=True, device="cpu", cache=cache)
    assert p.source == "autotune" and p.engine != "esc"
    assert cache.is_quarantined(p.cache_key, "esc")
    assert "esc|" not in cache.get(p.cache_key)["timings"]


# ---------------------------------------------------------------------------
# retry / deadline / degradation (execute_resilient)
# ---------------------------------------------------------------------------

def test_degrade_chain_is_the_references_with_the_plain_tier():
    from repro.core import dispatch as ref_dp
    assert [e for e, _ in dp.DEGRADE_CHAIN] == \
        [e for e, _ in ref_dp.DEGRADE_CHAIN]
    assert dp.DEGRADE_CHAIN[0] == ("spz-fused", "torch")
    assert dp.degrade_chain("cpu") == dp.degrade_chain(
        torch.device("cpu")) == dp.DEGRADE_CHAIN
    assert dp.RetryPolicy().fallback is None  # the plan's device decides


def test_degrade_chain_on_the_card_keeps_to_the_kernels():
    """A plan on a card degrades only to what runs there on the kernels:
    spz-fused/cuda, then esc.  No plain-tier rung, no host oracle."""
    chain = dp.degrade_chain("cuda")
    assert chain == dp.degrade_chain(torch.device("cuda", 0)) == \
        dp.DEGRADE_CHAIN_CUDA == (("spz-fused", "cuda"), ("esc", None))
    assert all(bk != "torch" and eng != "scl-array" for eng, bk in chain)


def test_execute_resilient_walks_the_plans_device_chain(cache):
    """A card plan (built here without a card: every attempt fails at the
    injected fault before it reaches the card) walks the card's ladder."""
    m = _mat(seed=16)
    p = dp.plan(m, m, engine="spz", device="cpu", cache=cache)
    kw = dict(p.kwargs_dict, device=torch.device("cuda"), backend="cuda")
    p = dataclasses.replace(p, backend="cuda",
                            kwargs=tuple(sorted(kw.items())))
    with fi.injected(fi.FaultSpec(site="dispatch.execute")):
        with pytest.raises(dp.ExhaustedFallbacks) as ei:
            dp.execute_resilient(p, m, m, policy=_nosleep_policy(),
                                 cache=cache)
    assert ei.value.report.quarantined == [
        ("spz", "cuda"), ("spz-fused", "cuda"), ("esc", None)]
    assert ei.value.report.attempts == 3 * 3


@pytest.mark.parametrize("error", [_build.KernelBuildError,
                                   _build.KernelLaunchError])
def test_kernel_errors_are_raised_not_degraded(error, cache):
    """A kernel that does not build or launch is a fault to report, not
    a reason to serve from a lower tier or to lose an autotune sweep."""
    def broken(A, B, **kw):
        raise error("synthetic kernel fault")
    assert issubclass(error, kb.KERNEL_ERRORS)
    dp.register_engine("broken-kernel", broken, measure=True,
                       description="always raises a kernel error (test)")
    try:
        m = _mat(seed=17)
        p = dp.plan(m, m, engine="broken-kernel", device="cpu", cache=cache)
        with pytest.raises(error):
            dp.execute_resilient(p, m, m, policy=_nosleep_policy(),
                                 cache=cache)
        assert not cache.is_quarantined(p.cache_key, "broken-kernel")
        with pytest.raises(error):
            dp.plan(m, m, autotune=True, device="cpu", cache=cache)
    finally:
        dp._REGISTRY.pop("broken-kernel", None)


def test_execute_resilient_retries_transient_fault(cache):
    m = _mat(seed=10)
    p = dp.plan(m, m, engine="esc", device="cpu", cache=cache)
    naps = []
    policy = _nosleep_policy(sleep=naps.append)
    with fi.injected(fi.FaultSpec(site="dispatch.execute", max_fires=2)):
        out, report = dp.execute_resilient(p, m, m, policy=policy,
                                           cache=cache)
    assert report.tier == 0 and report.attempts == 3
    assert report.tier_label == "planned" and not report.degraded
    assert naps == [policy.backoff_s(1), policy.backoff_s(2)]
    assert naps[1] == naps[0] * policy.backoff_factor
    np.testing.assert_allclose(_dense(out),
                               _dense(sg.spgemm_scl_array(m, m)),
                               rtol=1e-4, atol=1e-4)


def test_execute_resilient_degrades_and_quarantines(cache):
    """The planned spz fails persistently: the first rung of the ladder,
    spz-fused on the plain torch tier, serves the same CSR, and the
    planned combo is quarantined."""
    m = _mat(seed=11, pattern="powerlaw")
    p = dp.plan(m, m, engine="spz", device="cpu", cache=cache)
    want = dp.execute(p, m, m)
    with fi.injected(fi.FaultSpec(site="dispatch.execute",
                                  match={"engine": "spz"})):
        out, report = dp.execute_resilient(p, m, m,
                                           policy=_nosleep_policy(),
                                           cache=cache)
    assert report.degraded and report.tier == 1
    assert report.tier_label == "degraded:spz-fused/torch"
    assert report.attempts == 4
    assert cache.is_quarantined(p.cache_key, "spz", "torch")
    assert report.quarantined == [("spz", "torch")]
    for a, b in zip(csr_to_numpy(out), csr_to_numpy(want)):
        assert np.array_equal(a, b)
    # the next plan of the bucket routes around the poisoned combo
    q = dp.plan(m, m, device="cpu", cache=cache)
    assert (q.engine, q.backend) != ("spz", "torch")


def test_execute_resilient_skips_the_planned_rung(cache):
    """A plan for spz-fused/torch fails: the ladder does not retry the
    same rung, and the next one is esc."""
    m = _mat(seed=11)
    p = dp.plan(m, m, engine="spz-fused", device="cpu", cache=cache)
    with fi.injected(fi.FaultSpec(site="dispatch.execute",
                                  match={"engine": "spz-fused"})):
        out, report = dp.execute_resilient(p, m, m,
                                           policy=_nosleep_policy(),
                                           cache=cache)
    assert report.tier_label == "degraded:esc" and report.engine == "esc"
    assert ("spz-fused", "torch") in report.quarantined
    np.testing.assert_allclose(_dense(out),
                               _dense(sg.spgemm_scl_array(m, m)),
                               rtol=1e-4, atol=1e-4)


def test_execute_resilient_catches_silent_corruption(cache):
    m = _mat(seed=12)
    p = dp.plan(m, m, engine="esc", device="cpu", cache=cache)
    with fi.injected(fi.FaultSpec(site="dispatch.execute", kind="nan",
                                  max_fires=1)):
        out, report = dp.execute_resilient(p, m, m,
                                           policy=_nosleep_policy(),
                                           cache=cache)
    assert report.attempts == 2 and report.tier == 0
    assert "CorruptOutput" in report.errors[0]
    dp.check_result(out)


def test_execute_resilient_deadline(cache):
    m = _mat(seed=13)
    p = dp.plan(m, m, engine="esc", device="cpu", cache=cache)
    clock = VirtualClock()
    policy = _nosleep_policy(deadline_s=1.0, clock=clock,
                             sleep=lambda s: clock.advance(10.0))
    with fi.injected(fi.FaultSpec(site="dispatch.execute")):
        with pytest.raises(dp.DeadlineExceeded):
            dp.execute_resilient(p, m, m, policy=policy, cache=cache)


def test_execute_resilient_exhausts_all_tiers(cache):
    m = _mat(seed=14)
    p = dp.plan(m, m, engine="esc", device="cpu", cache=cache)
    with fi.injected(fi.FaultSpec(site="dispatch.execute")):
        with pytest.raises(dp.ExhaustedFallbacks) as ei:
            dp.execute_resilient(p, m, m, policy=_nosleep_policy(),
                                 cache=cache)
    report = ei.value.report
    assert report.attempts == 3 * 3
    assert report.quarantined == [("esc", None), ("spz-fused", "torch"),
                                  ("scl-array", None)]
    for eng, bk in report.quarantined:
        assert cache.is_quarantined(p.cache_key, eng, bk)


def test_execute_resilient_returns_stats_and_keeps_the_device(cache):
    m = _mat(seed=15, pattern="powerlaw")
    p = dp.plan(m, m, engine="spz", device="cpu", cache=cache)
    (out, stats), report = dp.execute_resilient(p, m, m, cache=cache,
                                                return_stats=True)
    assert report.tier_label == "planned" and stats.n_mssort > 0
    fb = dp.fallback_plan(p, "esc", None)
    assert fb.source == "fallback" and fb.backend is None
    assert fb.kwargs_dict == {"device": torch.device("cpu")}
    assert dp.fallback_plan(p, "spz-fused", None).backend == "torch"


def test_execute_batched_never_falls_back(cache):
    mats = [_mat(seed=s) for s in (1, 2)]
    b = batch_csr(mats)
    p = dp.plan_batched(b, b, "esc", device="cpu", cache=cache)
    with fi.injected(fi.FaultSpec(site="kernel.batched")):
        with pytest.raises(fi.InjectedFault):
            dp.execute_batched(p, b, b)
    with fi.injected(fi.FaultSpec(site="dispatch.execute_batched",
                                  kind="garbage")):
        out = dp.execute_batched(p, b, b)
    assert (out.indices[:, :1] == -7).all()
