"""The port's dispatch layer against the JAX reference, on the CPU.

``repro_torch.core.spgemm(A, B)`` with no engine named must pick the
engine the reference's ``spgemm(A, B)`` picks: the same Table III
features (ints equal, floats within 1e-9 relative), the same (engine,
rule) from the heuristic table, the same ``explain`` and the same
autotune-cache keys, on the 13 stand-ins and the four full-size
matrices of ``repro_torch.data.table3``.  The rest ports the cache and
plan cases of ``tests/test_dispatch.py`` and ``tests/test_plan_execute.py``
(each on a ``tmp_path`` cache, ``device="cpu"``), and loads cache files
the reference wrote (schema v1 and v2, its ``xla``/``pallas`` backends).
"""
import functools
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as ref_dp
from repro.core import formats as ref_formats
from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm_engines as sg
from repro_torch.core.formats import csr_to_numpy, random_sparse
from repro_torch.data import table3
from repro_torch.kernels import backend as kb

torch.set_num_threads(2)

FULL = [*table3.names(full=True), table3.LONG_ROW]


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return table3.build(name)


def _ref_csr(m):
    indptr, idx, data = (t.numpy() for t in (m.indptr, m.indices, m.data))
    return ref_formats.CSR(jnp.asarray(indptr), jnp.asarray(idx),
                           jnp.asarray(data), m.shape)


def _dense(m):
    return m.to_dense().numpy().astype(np.float64)


def _bit_equal(a, b):
    for x, y in zip(csr_to_numpy(a), csr_to_numpy(b)):
        assert np.array_equal(x, y)
        if x.dtype.kind == "f":
            assert np.array_equal(x.view(np.int32), y.view(np.int32))


@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


# ---------------------------------------------------------------------------
# selection against the reference, on the 17 matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", table3.names() + FULL)
def test_selection_matches_reference(name, tmp_path):
    A = _matrix(name)
    Ar = _ref_csr(A)
    got, want = dp.extract_features(A, A), ref_dp.extract_features(Ar, Ar)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-9, abs=0.0), k
        else:
            assert type(got[k]) is type(w) and got[k] == w, k
    assert dp.choose_engine(got) == ref_dp.choose_engine(want)
    assert dp.cache_key(A, A) == ref_dp.cache_key(Ar, Ar)
    assert dp.cache_key(A, A, backend="torch") == \
        ref_dp.cache_key(Ar, Ar, backend="torch")
    mine = dp.explain(A, A, device="cpu",
                      cache=dp.AutotuneCache(str(tmp_path / "p.json")))
    theirs = ref_dp.explain(Ar, Ar, cache=ref_dp.AutotuneCache(
        str(tmp_path / "r.json")))
    for k in ("engine", "rule", "cache_key"):
        assert mine[k] == theirs[k], k
    assert mine["model"] is None
    assert mine["backend"] == ("torch" if dp.get_engine(
        mine["engine"]).backend_aware else None)


def test_auto_choices_on_table3():
    """What ``engine="auto"`` picks on the 17 matrices (the same as the
    reference, per the test above): the default rule for 9 stand-ins,
    skewed for wiki and ndwww, dense for bcsstk17 and p3d and for every
    full-size matrix but email-Enron-full."""
    chosen = {n: dp.choose_engine(dp.extract_features(_matrix(n),
                                                      _matrix(n)))
              for n in table3.names() + FULL}
    assert {n for n, c in chosen.items() if c == ("spz-rsort", "skewed")} \
        == {"wiki", "ndwww"}
    assert {n for n, c in chosen.items() if c == ("esc", "dense")} == \
        {"bcsstk17", "p3d", "cage11-full", "hub-full", "dense-row-full"}
    assert {n for n, c in chosen.items() if c == ("spz", "default")} == \
        set(table3.names()) - {"wiki", "ndwww", "bcsstk17", "p3d"} \
        | {"email-Enron-full"}


def test_auto_runs_the_chosen_engine(tmp_path):
    """``spgemm(A, A, device="cpu")`` with no engine runs the engine the
    plan names, bit for bit, on a stand-in of each of the rules (each on
    a cache of its own: wiki and p3d share a shape/nnz bucket, so one
    cache would replay the first one's selection for the second)."""
    for name in ("usroads", "wiki", "p3d"):
        A = _matrix(name)
        cache = dp.AutotuneCache(str(tmp_path / f"{name}.json"))
        p = dp.plan(A, A, device="cpu", cache=cache)
        want = ref_dp.choose_engine(ref_dp.extract_features(_ref_csr(A),
                                                            _ref_csr(A)))
        assert (p.engine, p.rule, p.source) == (*want, "heuristic")
        _bit_equal(dp.spgemm(A, A, device="cpu", cache=cache),
                   dp.spgemm(A, A, engine=p.engine, device="cpu"))


# ---------------------------------------------------------------------------
# registry and heuristics (tests/test_dispatch.py)
# ---------------------------------------------------------------------------

def test_registry_has_all_paper_engines():
    engines = dp.available_engines()
    assert {"scl-array", "scl-hash", "esc", "spz", "spz-rsort"} <= \
        set(engines)
    assert set(engines) == set(ref_dp.available_engines())
    for name, spec in engines.items():
        ref = ref_dp.get_engine(name)
        assert (spec.returns_stats, spec.batchable, spec.measure,
                spec.backend_aware) == (ref.returns_stats, ref.batchable,
                                        ref.measure, ref.backend_aware), name


def test_register_and_unknown_engine():
    spec = dp.register_engine(
        "test-dummy", lambda A, B, *, device: sg.spgemm_scl_array(A, B),
        description="test-only")
    try:
        assert dp.get_engine("test-dummy") is spec
        A = random_sparse(16, 16, 0.05, seed=0)
        out = dp.spgemm(A, A, engine="test-dummy", device="cpu")
        np.testing.assert_allclose(_dense(out),
                                   _dense(sg.spgemm_scl_array(A, A)))
    finally:
        dp._REGISTRY.pop("test-dummy", None)
    with pytest.raises(ValueError, match="unknown engine"):
        dp.get_engine("test-dummy")


# (regime, generator args) spanning the heuristic table's density regimes
REGIMES = {
    "tiny": dict(n=24, density=0.002, pattern="uniform"),
    "dense": dict(n=64, density=0.05, pattern="uniform"),
    "skewed": dict(n=96, density=0.02, pattern="powerlaw"),
    "mid": dict(n=96, density=0.008, pattern="banded"),
}


def _regime_matrix(spec, seed=3):
    return random_sparse(spec["n"], spec["n"], spec["density"], seed=seed,
                         pattern=spec["pattern"])


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_auto_matches_oracle_per_regime(regime, cache):
    A = _regime_matrix(REGIMES[regime])
    want = _dense(sg.spgemm_scl_array(A, A))
    got = _dense(dp.spgemm(A, A, device="cpu", cache=cache))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    p = dp.plan(A, A, device="cpu", cache=cache)
    Ar = _ref_csr(A)
    assert p.engine == ref_dp.choose_engine(ref_dp.extract_features(Ar,
                                                                    Ar))[0]


def test_auto_selects_different_engines_across_regimes():
    chosen = {r: dp.explain(_regime_matrix(s), _regime_matrix(s),
                            device="cpu")["engine"]
              for r, s in REGIMES.items()}
    assert len(set(chosen.values())) >= 2, chosen


def test_explain_reports_features_and_rule(cache):
    A = _regime_matrix(REGIMES["dense"])
    info = dp.explain(A, A, device="cpu", cache=cache)
    assert info["engine"] in dp.available_engines()
    assert {"density", "total_work", "avg_work_per_row"} <= set(
        info["features"])
    assert info["cache_key"] == dp.cache_key(A, A)
    assert set(info) == {"engine", "rule", "backend", "features",
                         "cache_key", "model"}


def test_custom_rules_override():
    A = _regime_matrix(REGIMES["dense"])
    rules = (dp.HeuristicRule("always-hash", lambda f: True, "scl-hash"),)
    assert dp.choose_engine(dp.extract_features(A, A), rules) == \
        ("scl-hash", "always-hash")


def test_custom_rules_bypass_cache(cache):
    """A cached default-rules plan must not shadow caller rules, and a
    custom-rules selection must not be written into the cache."""
    A = _regime_matrix(REGIMES["dense"])  # default rules pick esc
    dp.spgemm(A, A, device="cpu", cache=cache)
    assert cache.get(dp.cache_key(A, A))["engine"] == "esc"
    rules = (dp.HeuristicRule("always-hash", lambda f: True, "scl-hash"),)
    out = dp.spgemm(A, A, device="cpu", cache=cache, rules=rules)
    np.testing.assert_allclose(_dense(out),
                               _dense(sg.spgemm_scl_array(A, A)),
                               rtol=1e-4, atol=1e-4)
    assert cache.get(dp.cache_key(A, A)) == {"engine": "esc",
                                             "source": "heuristic"}


def test_auto_drops_engine_specific_kwargs(cache):
    """spz kwargs must not crash an auto run that selects esc; an
    explicitly named engine stays strict."""
    A = _regime_matrix(REGIMES["dense"])  # auto -> esc
    p = dp.plan(A, A, device="cpu", cache=cache, R=16, backend="torch")
    assert p.engine == "esc" and "R" not in p.kwargs_dict
    assert p.backend is None and "backend" not in p.kwargs_dict
    np.testing.assert_allclose(_dense(dp.execute(p, A, A)),
                               _dense(sg.spgemm_scl_array(A, A)),
                               rtol=1e-4, atol=1e-4)
    strict = dp.plan(A, A, "esc", device="cpu", R=16)
    assert strict.kwargs_dict == {"R": 16, "device": torch.device("cpu")}
    with pytest.raises(TypeError):
        dp.execute(strict, A, A)


def test_inner_dim_mismatch_raises():
    A = random_sparse(8, 9, 0.1, seed=0)
    with pytest.raises(ValueError, match="inner dims"):
        dp.spgemm(A, A, engine="scl-array", device="cpu")


# ---------------------------------------------------------------------------
# the autotune cache (tests/test_dispatch.py)
# ---------------------------------------------------------------------------

def test_default_cache_path(tmp_path, monkeypatch):
    """The port's cache file is its own: ``$REPRO_TORCH_AUTOTUNE_CACHE``
    or ``~/.cache/repro_torch/``, never the reference's file."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    assert dp.AutotuneCache().path == str(
        tmp_path / ".cache" / "repro_torch" / "spgemm_autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "p.json"))
    assert dp.AutotuneCache().path == str(tmp_path / "p.json")


def test_heuristic_plan_is_cached_and_reused(cache):
    A = _regime_matrix(REGIMES["mid"])
    dp.spgemm(A, A, device="cpu", cache=cache)
    key = dp.cache_key(A, A)
    hit = cache.get(key)
    assert hit is not None and hit["source"] == "heuristic"
    assert dp.AutotuneCache(cache.path).get(key) == hit


def test_autotune_measures_and_sticks(cache):
    A = random_sparse(24, 24, 0.05, seed=1)
    out = dp.spgemm(A, A, autotune=True, device="cpu", cache=cache)
    np.testing.assert_allclose(_dense(out),
                               _dense(sg.spgemm_scl_array(A, A)),
                               rtol=1e-4, atol=1e-4)
    hit = cache.get(dp.cache_key(A, A))
    assert hit["source"] == "autotune"
    assert hit["engine"] in dp.available_engines()
    assert set(hit["timings"]) == {
        "scl-array|", "scl-hash|", "esc|", "spz|torch", "spz-rsort|torch"}
    assert hit["features"] == dp.extract_features(A, A)
    # a later non-autotune call must keep the measured plan
    dp.spgemm(A, A, device="cpu", cache=cache)
    assert cache.get(dp.cache_key(A, A)) == hit


def test_corrupt_cache_file_starts_empty(tmp_path):
    p = tmp_path / "autotune.json"
    p.write_text("{not json")
    c = dp.AutotuneCache(str(p))
    assert len(c) == 0
    c.put("k", "esc", "heuristic")
    assert dp.AutotuneCache(str(p)).get("k") == {"engine": "esc",
                                                 "source": "heuristic"}
    assert (tmp_path / "autotune.json.corrupt").read_text() == "{not json"


def test_truncated_cache_file_recovers(tmp_path):
    p = tmp_path / "autotune.json"
    full = json.dumps({"k": {"engine": "esc", "source": "heuristic"}})
    p.write_text(full[:len(full) // 2])
    c = dp.AutotuneCache(str(p))
    assert len(c) == 0
    c.put("k2", "spz", "heuristic")
    assert dp.AutotuneCache(str(p)).get("k2") is not None


def test_flush_is_atomic_tempfile_rename(tmp_path, monkeypatch):
    """Writes go to a tempfile published by rename: a crash between the
    write and the rename leaves the previous complete file."""
    p = tmp_path / "autotune.json"
    c = dp.AutotuneCache(str(p))
    c.put("k1", "esc", "heuristic")
    before = p.read_text()
    real_replace = os.replace
    seen = {}

    def failing_replace(srcf, dst):
        if dst == str(p):
            seen["tmp"] = srcf
            raise OSError("simulated crash before publish")
        return real_replace(srcf, dst)

    monkeypatch.setattr(os, "replace", failing_replace)
    c.put("k2", "spz", "heuristic")
    monkeypatch.undo()
    assert seen["tmp"] != str(p)
    assert p.read_text() == before
    assert dp.AutotuneCache(str(p)).get("k2") is None
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_concurrent_writers_merge_not_clobber(tmp_path):
    p = str(tmp_path / "autotune.json")
    c1, c2 = dp.AutotuneCache(p), dp.AutotuneCache(p)
    c1.put("a", "esc", "heuristic")
    c2.put("b", "spz", "autotune")
    reread = dp.AutotuneCache(p)
    assert reread.get("a") == {"engine": "esc", "source": "heuristic"}
    assert reread.get("b") == {"engine": "spz", "source": "autotune"}
    # a stale heuristic writer never downgrades a measured entry
    c1.put("b", "esc", "heuristic")
    assert dp.AutotuneCache(p).get("b") == {"engine": "spz",
                                            "source": "autotune"}


def test_concurrent_flushes_lose_no_entries(tmp_path):
    """Many cache objects on one path flushing concurrently (one fd per
    object, across threads) lose no entry to the read-merge-write
    window: the fcntl lock serializes it."""
    p = str(tmp_path / "autotune.json")
    n_writers, n_keys = 6, 12
    barrier = threading.Barrier(n_writers)
    errors = []

    def writer(w):
        try:
            c = dp.AutotuneCache(p, lock_timeout_s=30.0)
            barrier.wait(timeout=30)
            for i in range(n_keys):
                c.put(f"w{w}-k{i}", "esc", "heuristic")
        except Exception as e:  # pragma: no cover - surfaced via errors
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
    final = dp.AutotuneCache(p)
    missing = [f"w{w}-k{i}" for w in range(n_writers)
               for i in range(n_keys) if final.get(f"w{w}-k{i}") is None]
    assert not missing, f"lost {len(missing)} entries: {missing[:5]}"


def test_cache_put_records_backend(tmp_path):
    c = dp.AutotuneCache(str(tmp_path / "autotune.json"))
    c.put("k", "spz-fused", "autotune", backend="cuda")
    assert c.get("k") == {"engine": "spz-fused", "source": "autotune",
                          "backend": "cuda"}
    assert dp.AutotuneCache(c.path).get("k")["backend"] == "cuda"
    v = c.version
    c.clear()
    assert len(c) == 0 and not os.path.exists(c.path) and c.version > v
    assert dp.split_combo(dp.combo_str("spz", "cuda")) == ("spz", "cuda")
    assert dp.split_combo(dp.combo_str("esc", None)) == ("esc", None)
    assert dp.combo_str("esc", None) == ref_dp.combo_str("esc", None)


# ---------------------------------------------------------------------------
# plans (tests/test_plan_execute.py)
# ---------------------------------------------------------------------------

def test_plan_execute_bit_identical_all_engines():
    """execute(plan(...)) == the engine called directly, bit for bit."""
    A = random_sparse(64, 64, 0.04, seed=7, pattern="powerlaw")
    cpu = torch.device("cpu")
    for name, spec in dp.available_engines().items():
        kw = {"backend": "torch"} if spec.backend_aware else {}
        direct = spec.fn(A, A, device=cpu, **kw)
        direct = direct[0] if spec.returns_stats else direct
        p = dp.plan(A, A, name, device="cpu")
        assert p.engine == name and p.source == "explicit"
        assert not p.batched and p.batch is None and p.rule is None
        _bit_equal(direct, dp.execute(p, A, A))


def test_plan_is_hashable_and_inspectable(cache):
    A = random_sparse(64, 64, 0.05, seed=0)
    p = dp.plan(A, A, "auto", device="cpu", cache=cache)
    assert isinstance(hash(p), int)
    assert p.engine in dp.available_engines()
    assert p.source == "heuristic" and p.rule is not None
    assert p.cache_key == dp.cache_key(A, A)
    assert p.jit_key == (p.engine, p.backend, False, None, p.a_shape,
                         p.b_shape, p.work_bucket, p.kwargs)
    assert p.kwargs_dict["device"] == torch.device("cpu")
    assert dp.plan(A, A, p.engine, device="cpu").jit_key == p.jit_key
    p2 = dp.plan(A, A, "auto", device="cpu", cache=cache)
    assert p2.source == "cache" and p2.engine == p.engine


def test_plan_reusable_across_matching_requests(cache):
    A = random_sparse(48, 48, 0.05, seed=1)
    p = dp.plan(A, A, "auto", device="cpu", cache=cache)
    for seed in (2, 3):
        M = random_sparse(48, 48, 0.05, seed=seed)
        np.testing.assert_allclose(_dense(dp.execute(p, M, M)),
                                   _dense(sg.spgemm_scl_array(M, M)),
                                   rtol=1e-4, atol=1e-4)


def test_execute_rejects_structure_mismatch():
    A = random_sparse(32, 32, 0.05, seed=0)
    C = random_sparse(16, 16, 0.05, seed=0)
    p = dp.plan(A, A, "esc", device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        dp.execute(p, C, C)


def test_plan_memo_on_operand_identity(tmp_path, monkeypatch):
    """Repeat plans on the same matrix objects skip selection entirely
    (a memo hit returns the identical plan object)."""
    dp.clear_feature_cache()
    monkeypatch.setattr(dp, "_default_cache",
                        dp.AutotuneCache(str(tmp_path / "private.json")))
    A = random_sparse(48, 48, 0.03, seed=5)
    before = dp._plan_memo.hits
    p1 = dp.plan(A, A, device="cpu")
    p2 = dp.plan(A, A, device="cpu")
    assert p2 is p1 and dp._plan_memo.hits == before + 1
    dp.clear_feature_cache()


def test_plan_memo_invalidated_by_autotune(tmp_path, monkeypatch):
    """An autotune upgrade must not be shadowed by a stale memoized plan."""
    dp.clear_feature_cache()
    monkeypatch.setattr(dp, "_default_cache",
                        dp.AutotuneCache(str(tmp_path / "private.json")))
    A = random_sparse(24, 24, 0.05, seed=1)
    p1 = dp.plan(A, A, device="cpu")
    tuned = dp.plan(A, A, device="cpu", autotune=True)
    assert tuned.source == "autotune"
    p2 = dp.plan(A, A, device="cpu")
    assert p2.source == "cache" and p2.engine == tuned.engine
    assert p1 is not p2
    dp.clear_feature_cache()


def test_plan_resolves_backend_into_kwargs_and_jit_key():
    A = random_sparse(48, 48, 0.05, seed=2)
    p = dp.plan(A, A, "spz-fused", backend="torch", device="cpu", R=8)
    assert p.backend == "torch" and p.kwargs_dict["backend"] == "torch"
    pa = dp.plan(A, A, "spz-fused", device="cpu", R=8)
    assert pa.backend == kb.resolve_backend("auto", "cpu").name == "torch"
    assert pa.jit_key == p.jit_key
    with pytest.raises(ValueError, match="runs on cuda"):
        dp.plan(A, A, "spz-fused", backend="cuda", device="cpu")


def test_plan_backend_for_non_aware_engine(cache):
    A = random_sparse(64, 64, 0.05, seed=3)  # dense regime -> esc
    with pytest.raises(ValueError, match="does not take a kernel backend"):
        dp.plan(A, A, "esc", backend="torch", device="cpu")
    p = dp.plan(A, A, "auto", backend="torch", device="cpu", cache=cache)
    assert p.engine == "esc" and p.backend is None
    assert "backend" not in p.kwargs_dict


def test_two_backends_autotune_independently(tmp_path):
    """The same shape bucket autotunes one plan per pinned backend:
    distinct cache keys, distinct sticky entries.  A second CPU backend
    (a copy of the torch tier) is registered for the test."""
    import dataclasses
    kb._BACKENDS["torch-b"] = dataclasses.replace(
        kb.get_backend("torch"), name="torch-b")
    try:
        cache = dp.AutotuneCache(str(tmp_path / "autotune.json"))
        A = random_sparse(16, 16, 0.08, seed=1)
        pa = dp.plan(A, A, backend="torch", autotune=True, device="cpu",
                     cache=cache)
        pb = dp.plan(A, A, backend="torch-b", autotune=True, device="cpu",
                     cache=cache)
        assert pa.source == pb.source == "autotune"
        assert pa.cache_key.endswith("|bk=torch")
        assert pb.cache_key.endswith("|bk=torch-b")
        ea, eb = cache.get(pa.cache_key), cache.get(pb.cache_key)
        assert ea["source"] == eb["source"] == "autotune"
        assert not any(c.endswith("|torch-b") for c in ea["timings"])
        assert not any(c.endswith("|torch") for c in eb["timings"])
        if dp.get_engine(pb.engine).backend_aware:
            assert pb.backend == "torch-b" and eb["backend"] == "torch-b"
        p2 = dp.plan(A, A, backend="torch-b", device="cpu", cache=cache)
        assert p2.source == "cache" and p2.engine == pb.engine
        assert p2.backend == pb.backend
    finally:
        kb._BACKENDS.pop("torch-b", None)


def test_autotune_sweeps_the_measurable_backends(tmp_path, monkeypatch):
    """With backend="auto" every backend-aware engine is measured once
    per backend measurable on the device: torch on the CPU; on a CUDA
    device only cuda — the plain torch tier never joins a sweep there."""
    cache = dp.AutotuneCache(str(tmp_path / "autotune.json"))
    A = random_sparse(12, 12, 0.1, seed=4)
    measured = []
    real = dp._measure

    def spy(spec, a, b, repeat=1, backend=None, device=None):
        measured.append((spec.name, backend))
        return real(spec, a, b, repeat, backend, device)

    monkeypatch.setattr(dp, "_measure", spy)
    p = dp.plan(A, A, autotune=True, device="cpu", cache=cache)
    assert p.source == "autotune"
    assert {bk for n, bk in measured if n == "spz"} == {"torch"}
    assert ("esc", None) in measured
    assert not {n for n, _ in measured} & {"spz-fused", "spz-host"}
    assert [b.name for b in kb.measurable_backends("cpu")] == ["torch"]
    assert [b.name for b in kb.measurable_backends("cuda")] == ["cuda"]
    on_card = dp._measure_candidates("auto", torch.device("cuda"))
    assert ("spz", "cuda") in on_card and ("spz-rsort", "cuda") in on_card
    assert not [c for c in on_card if c[1] == "torch"]
    # a pinned backend is measured as it is
    assert ("spz", "torch") in dp._measure_candidates("torch",
                                                      torch.device("cuda"))


def test_measure_times_one_call():
    A = random_sparse(32, 32, 0.05, seed=2)
    t = dp._measure(dp.get_engine("spz"), A, A, repeat=2, backend="torch",
                    device="cpu")
    assert 0.0 < t < 60.0


def test_cached_backend_is_not_trusted_blindly(tmp_path):
    """A cache entry naming a backend the sweep would not measure on the
    plan's device — an unknown name, the reference's xla/pallas, cuda on
    the CPU, torch on a card — falls back to "auto" and never raises."""
    cache = dp.AutotuneCache(str(tmp_path / "autotune.json"))
    A = random_sparse(24, 24, 0.05, seed=6)
    key = dp.cache_key(A, A)
    for bad in ("no-such-backend", "pallas", "xla", "cuda"):
        cache.put(key, "spz-fused", "autotune", backend=bad)
        p = dp.plan(A, A, device="cpu", cache=cache)
        assert p.source == "cache" and p.engine == "spz-fused"
        assert p.backend == "torch"
        dp.execute(p, A, A)
    spec = dp.get_engine("spz")
    cuda = torch.device("cuda")
    assert dp._resolve_plan_backend(spec, "auto", "torch", {}, cuda)[0] \
        == "cuda"
    assert dp._resolve_plan_backend(spec, "auto", "cuda", {}, cuda)[0] \
        == "cuda"


def test_reference_cache_files_load(tmp_path):
    """Cache files the reference wrote — v1 (no schema record, TTL-less
    quarantine) and v2 (its own AutotuneCache, xla/pallas backends,
    timing vectors) — load in the port, and plans on them resolve the
    foreign backends to "auto" without raising."""
    A = random_sparse(24, 24, 0.05, seed=6)
    B = random_sparse(40, 40, 0.05, seed=7)
    Ar, Br = _ref_csr(A), _ref_csr(B)
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({
        ref_dp.cache_key(Ar, Ar): {"engine": "spz-fused",
                                   "source": "autotune",
                                   "backend": "pallas"},
        "!quarantine:" + ref_dp.cache_key(Br, Br): {"combos": ["spz|xla"]}}))
    v2 = str(tmp_path / "v2.json")
    rc = ref_dp.AutotuneCache(v2)
    rc.put(ref_dp.cache_key(Ar, Ar), "spz-rsort", "autotune",
           backend="xla", timings={"spz-rsort|xla": 0.1, "esc|": 0.2},
           features={"nnz": 10, "density": 0.5})
    rc.quarantine(ref_dp.cache_key(Br, Br), "esc", None, reason="crash")
    for path, engine, src_version in ((str(v1), "spz-fused", 1),
                                      (v2, "spz-rsort", 2)):
        c = dp.AutotuneCache(path)
        assert len(c) == 2
        assert c.loaded_schema_version == src_version
        p = dp.plan(A, A, device="cpu", cache=c)
        assert (p.source, p.engine, p.backend) == ("cache", engine, "torch")
        _bit_equal(dp.execute(p, A, A),
                   dp.spgemm(A, A, engine=engine, device="cpu"))
        q = dp.plan(B, B, device="cpu", cache=c)
        assert q.cache_key == ref_dp.cache_key(Br, Br)
        if src_version == 2:
            assert c.is_quarantined(q.cache_key, "esc")
            assert q.engine != "esc"
        dp.execute(q, B, B)
        assert c.get(p.cache_key)["engine"] == engine


def test_batched_plan_reads_the_same_cache(cache):
    """Batched auto selection consults and persists the same autotune
    cache as the single-matrix path, keyed on the heaviest lane."""
    from repro_torch.core.formats import batch_csr
    mats = [random_sparse(48, 48, d, seed=i)
            for i, d in enumerate((0.004, 0.05, 0.015, 0.03))]
    b = batch_csr(mats)
    p1 = dp.plan_batched(b, b, device="cpu", cache=cache)
    assert p1.source == "heuristic" and p1.batched and p1.batch == 4
    assert p1.cache_key == dp.cache_key(mats[1], mats[1])
    assert cache.get(p1.cache_key) is not None
    p2 = dp.plan_batched(b, b, device="cpu", cache=cache)
    assert p2.source == "cache" and p2.engine == p1.engine
