"""The port's learned dispatch — ``repro_torch.models.dispatch_model``,
``repro_torch.optim.adamw``, the ``"model"`` rung of ``plan``/
``plan_batched``/``explain`` and ``tools/dump_autotune_torch.py`` —
against the JAX reference, on the CPU.

Tolerances, set from float32 before the comparison: AdamW steps agree
within ``ADAM_ATOL`` per element over 50 steps (the step, the bias
corrections and the schedule are computed in float32 by both); a model
trained on the same samples agrees within ``W_ATOL`` on its weights
(Adam's normalised step turns float32 rounding in the loss's reductions
into drift along the directions the data leaves flat), ``PRED_ATOL`` on
every predicted log-runtime, ``BIAS_ATOL`` on its biases,
``SIGMA_ATOL`` on its residual noise and ``CONF_ATOL`` on every
confidence, and picks the same engine for every sample.
``predict``/``select`` are the reference's plain Python: an artifact of
either package predicts the same bits in the other.
"""
import dataclasses
import importlib.util
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from repro.core import dispatch as ref_dp
from repro.models import dispatch_model as ref_dm
from repro.optim import adamw as ref_adamw
from repro_torch.core import dispatch as dp
from repro_torch.core.formats import batch_csr, random_sparse
from repro_torch.models import dispatch_model as dm
from repro_torch.optim import adamw

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ADAM_ATOL = 1e-6
W_ATOL, BIAS_ATOL, SIGMA_ATOL, CONF_ATOL = 2e-2, 1e-3, 1e-3, 1e-2
PRED_ATOL = 1e-2


@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


def _mats(n=32, density=0.02, seed=0):
    return (random_sparse(n, n, density, seed=seed),
            random_sparse(n, n, density, seed=seed + 1000))


def _sweep(cache, sizes=(24, 48, 96), density=0.02):
    """Populate ``cache`` with the port's autotune sweeps on the CPU."""
    for i, n in enumerate(sizes):
        A, B = _mats(n, density, seed=i)
        dp.plan(A, B, autotune=True, cache=cache, model=False, device="cpu")


def _toy_samples(n=16, seed=0):
    """The reference test's synthetic dataset: a clean size-dependent
    winner crossover between esc and scl-hash."""
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        work = float(2 ** rng.uniform(6, 18))
        feats = {"nnz": work / 8, "density": min(0.5, work / 1e7),
                 "avg_work_per_row": work / 64,
                 "avg_work_per_group": work / 8,
                 "work_var_per_group": float(rng.uniform(0, 2)),
                 "total_work": work}
        samples.append({"key": f"b{i}", "features": feats, "timings": {
            "esc|": (1e-5 + 2e-9 * work) * rng.lognormal(0, 0.03),
            "scl-hash|": (2e-6 + 6e-8 * work) * rng.lognormal(0, 0.03),
        }})
    return samples


def _trained(cache, **kw):
    return dm.train_and_save(cache.entries(), dp.model_path_for(cache),
                             device="cpu", steps=150, **kw)


# ---------------------------------------------------------------------------
# the module against the reference
# ---------------------------------------------------------------------------

def test_featurize_and_samples_equal_the_references(cache):
    _sweep(cache)
    A, B = _mats(64, 0.002, seed=3)
    dp.plan(A, B, cache=cache, model=False, device="cpu")  # winner-only
    cache.quarantine("somekey", "esc", None, reason="x")
    entries = cache.entries()
    assert dm.FEATURE_NAMES == ref_dm.FEATURE_NAMES
    got, want = (m.samples_from_entries(entries) for m in (dm, ref_dm))
    assert got == want and len(got) == 3
    for s in got:
        assert dm.featurize(s["features"]) == \
            ref_dm.featurize(s["features"])
    odd = {"nnz": float("nan"), "density": 0.0, "total_work": -3.0}
    assert dm.featurize(odd) == ref_dm.featurize(odd)


def test_adamw_steps_match_the_reference():
    """50 steps of the port's AdamW and the reference's on the same named
    params and grads (clipping hit on every 7th step); the port's names
    are the reference's tree paths; no-decay names are not decayed."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    init = {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "bias": rng.normal(size=(4,)).astype(np.float32),
            "blk": {"scale": rng.normal(size=(3,)).astype(np.float32),
                    "kernel": rng.normal(size=(3, 2)).astype(np.float32)}}

    def flat(tree, f):
        return {"/".join(str(k.key) for k in path): f(x) for path, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
    kw = dict(lr=0.05, weight_decay=0.1, clip_norm=1.0, warmup_steps=5,
              decay_steps=50)
    cfg_r, cfg_t = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    pr = jax.tree_util.tree_map(jnp.asarray, init)
    pt = flat(init, torch.tensor)
    sr, st = ref_adamw.init_state(cfg_r, pr), adamw.init_state(cfg_t, pt)
    for i in range(50):
        g = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) *
                       (3.0 if i % 7 == 0 else 0.3)).astype(np.float32), init)
        pr, sr, mr = ref_adamw.apply_updates(
            cfg_r, pr, sr, jax.tree_util.tree_map(jnp.asarray, g))
        pt, st, mt = adamw.apply_updates(cfg_t, pt, st, flat(g, torch.tensor))
        for k in ("lr", "grad_norm"):   # float32: a few ulps
            assert float(mr[k]) == pytest.approx(float(mt[k]), rel=1e-6)
        want = flat(pr, np.asarray)
        assert sorted(want) == sorted(pt)
        for name, x in pt.items():
            np.testing.assert_allclose(x.numpy(), want[name], rtol=0,
                                       atol=ADAM_ATOL)
    assert int(st["step"]) == int(sr["step"]) == 50
    # zero gradients from a fresh state: decayed names shrink, the
    # no-decay names do not move
    zero = {k: torch.zeros_like(x) for k, x in pt.items()}
    p2, _, _ = adamw.apply_updates(cfg_t, pt, adamw.init_state(cfg_t, pt),
                                   zero)
    for name, moved in (("bias", False), ("blk/scale", False), ("w", True),
                        ("blk/kernel", True)):
        assert torch.equal(p2[name], pt[name]) != moved, name


@pytest.mark.parametrize("n,steps", [(24, 250), (40, 400)])
def test_training_matches_the_reference(n, steps):
    samples = _toy_samples(n, seed=n)
    want = ref_dm.DispatchModel.train(samples, steps=steps)
    got = dm.DispatchModel.train(samples, steps=steps, device="cpu")
    assert got.candidates == want.candidates
    np.testing.assert_allclose(got.w, want.w, rtol=0, atol=W_ATOL)
    np.testing.assert_allclose(got.bias, want.bias, rtol=0, atol=BIAS_ATOL)
    assert abs(got.sigma - want.sigma) <= SIGMA_ATOL
    np.testing.assert_array_equal(got.mean, want.mean)
    np.testing.assert_array_equal(got.std, want.std)
    for s in samples:
        g, w = got.select(s["features"]), want.select(s["features"])
        assert g.combo == w.combo
        assert abs(g.confidence - w.confidence) <= CONF_ATOL
        for c in got.candidates:
            assert abs(math.log(g.costs[c]) - math.log(w.costs[c])) \
                <= PRED_ATOL


def test_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dm.DispatchModel.train(_toy_samples(4))


def test_artifacts_cross_load_and_predict_bit_for_bit(tmp_path):
    samples = _toy_samples(16)
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path / "p.json")
    ref_dm.DispatchModel.train(samples, steps=60).save(ref_path)
    dm.DispatchModel.train(samples, steps=60, device="cpu").save(port_path)
    for path in (ref_path, port_path):
        a, b = dm.DispatchModel.load(path), ref_dm.DispatchModel.load(path)
        assert a.to_dict() == b.to_dict()
        for s in samples:
            assert a.predict(s["features"]) == b.predict(s["features"])
            assert dataclasses.asdict(a.select(s["features"])) == \
                dataclasses.asdict(b.select(s["features"]))


def test_model_select_respects_allowed_and_abstains():
    m = dm.DispatchModel.train(_toy_samples(12), steps=100, device="cpu")
    feats = _toy_samples(1)[0]["features"]
    only = m.select(feats, allowed={"esc|"})
    assert only.combo == "esc|" and only.confidence == 1.0
    sel = m.select(feats, allowed={"esc|", "scl-hash|", "mystery|"})
    assert not sel.confident
    assert m.select(feats, allowed={"mystery|"}) is None
    assert m.select(feats, allowed=set()) is None
    assert dm.DispatchModel.train([], device="cpu") is None


def test_artifact_versioning(tmp_path):
    path = str(tmp_path / "cache.json") + dp.MODEL_SUFFIX
    entries = {s["key"]: {"engine": "esc", "source": "autotune",
                          "timings": s["timings"],
                          "features": s["features"]}
               for s in _toy_samples(10)}
    assert dm.train_and_save(entries, path, device="cpu",
                             steps=60).version == 1
    assert dm.train_and_save(entries, path, device="cpu",
                             steps=60).version == 2
    blob = json.loads(open(path).read())
    blob["format_version"] = dm.FORMAT_VERSION + 1
    open(path, "w").write(json.dumps(blob))
    with pytest.raises(ValueError, match="format_version"):
        dm.DispatchModel.load(path)


# ---------------------------------------------------------------------------
# the "model" rung of the selection ladder (as tests/test_learned_dispatch.py
# holds the reference's)
# ---------------------------------------------------------------------------

def test_plan_uses_confident_model(cache):
    _sweep(cache)
    model = _trained(cache)
    model.confidence_floor = 0.0          # force the prediction through
    A, B = _mats(64, 0.02, seed=77)       # unseen bucket
    p = dp.plan(A, B, cache=cache, model=model, device="cpu")
    assert p.source == "model" and p.engine in dp.available_engines()
    assert cache.get(p.cache_key) is None  # the bucket stays open
    want = dp.spgemm(A, B, engine=p.engine, device="cpu",
                     **({"backend": p.backend} if p.backend else {}))
    got = dp.execute(p, A, B)
    for x, y in zip((want.indptr, want.indices, want.data),
                    (got.indptr, got.indices, got.data)):
        assert torch.equal(x, y)


def test_plan_low_confidence_falls_through(cache):
    _sweep(cache)
    model = _trained(cache)
    model.confidence_floor = 1.1          # nothing can clear the floor
    A, B = _mats(64, 0.02, seed=78)
    assert dp.plan(A, B, cache=cache, model=model,
                   device="cpu").source == "heuristic"
    A2, B2 = _mats(80, 0.02, seed=79)
    p2 = dp.plan(A2, B2, autotune=True, cache=cache, model=model,
                 device="cpu")
    assert p2.source == "autotune" and cache.get(p2.cache_key)["timings"]


def test_plan_model_auto_loads_artifact_and_cache_wins(cache):
    _sweep(cache)
    _trained(cache, confidence_floor=0.0)
    A, B = _mats(64, 0.02, seed=80)
    assert dp.plan(A, B, cache=cache, device="cpu").source == "model"
    A0, B0 = _mats(24, 0.02, seed=0)      # a swept bucket
    assert dp.plan(A0, B0, cache=cache, device="cpu").source == "cache"
    assert dp.plan(A, B, cache=cache, model=False,
                   device="cpu").source == "heuristic"


def test_model_is_quarantine_aware(cache):
    _sweep(cache)
    model = _trained(cache, confidence_floor=0.0)
    A, B = _mats(64, 0.02, seed=81)
    first = dp.plan(A, B, cache=cache, model=model, device="cpu")
    assert first.source == "model"
    cache.quarantine(first.cache_key, first.engine, first.backend,
                     reason="crash")
    again = dp.plan(A, B, cache=cache, model=model, device="cpu")
    assert (again.engine, again.backend) != (first.engine, first.backend)


def test_plan_batched_model_source(cache):
    _sweep(cache)
    _trained(cache, confidence_floor=0.0)
    lanes = [random_sparse(64, 64, 0.02, seed=90 + i) for i in range(3)]
    A = batch_csr(lanes, batch_cap=len(lanes))
    p = dp.plan_batched(A, A, cache=cache, device="cpu")
    assert p.source == "model" and p.engine in dp._BATCH_DRIVERS


def test_explain_surfaces_model(cache):
    _sweep(cache)
    _trained(cache)
    A, B = _mats(64, 0.02, seed=82)
    mi = dp.explain(A, B, cache=cache, device="cpu")["model"]
    assert mi["engine"] and 0.0 <= mi["confidence"] <= 1.0
    assert isinstance(mi["confident"], bool) and mi["version"] == 1
    assert all(t > 0 for t in mi["costs"].values())
    other = dp.AutotuneCache(os.path.join(os.path.dirname(cache.path),
                                          "other.json"))
    assert dp.explain(A, B, cache=other, device="cpu")["model"] is None


def test_corrupt_artifact_never_fails_a_plan(cache):
    _sweep(cache)
    with open(dp.model_path_for(cache), "w") as f:
        f.write("{not json")
    A, B = _mats(64, 0.02, seed=83)
    assert dp.plan(A, B, cache=cache, device="cpu").source in (
        "heuristic", "cache")


def test_cpu_trained_model_abstains_on_the_card(cache):
    """A model trained from CPU sweeps knows ``spz|torch``; on a card the
    candidates are ``spz|cuda``, which it never saw: it abstains, and
    the plan would fall through to measurement or the table."""
    _sweep(cache)
    model = _trained(cache, confidence_floor=0.0)
    assert "spz|torch" in model.candidates
    A, B = _mats(64, 0.02, seed=84)
    key = dp.cache_key(A, B)
    feats = dp.extract_features(A, B)
    on_cpu = dp._model_select(model, feats, key, "auto", cache, "cpu")
    assert on_cpu is not None and on_cpu.confident
    allowed = dp._model_candidates(key, "auto", cache, torch.device("cuda"))
    assert "spz|cuda" in allowed and "spz|torch" not in allowed
    on_card = dp._model_select(model, feats, key, "auto", cache,
                               torch.device("cuda"))
    assert on_card is None or not on_card.confident


def test_model_never_plans_a_host_engine_on_the_card(cache):
    """A model whose cheapest combo is ``scl-hash`` picks it on the CPU;
    on a card the host engines are no candidates, so the model picks
    among the card's engines and never moves the multiply to the CPU."""
    combos = ["scl-hash|", "scl-array|", "esc|", "spz|torch",
              "spz-rsort|torch", "spz|cuda", "spz-rsort|cuda"]
    bias = [-12.0, -11.0, -8.0, -7.0, -6.0, -9.0, -5.0]
    d = len(dm.FEATURE_NAMES)
    model = dm.DispatchModel(candidates=combos,
                             w=np.zeros((len(combos), d)), bias=bias,
                             mean=np.zeros(d), std=np.ones(d), sigma=0.05)
    A, B = _mats(64, 0.02, seed=85)
    key = dp.cache_key(A, B)
    feats = dp.extract_features(A, B)
    on_cpu = dp._model_select(model, feats, key, "auto", cache, "cpu")
    assert on_cpu.confident and on_cpu.combo == "scl-hash|"
    card = torch.device("cuda")
    allowed = dp._model_candidates(key, "auto", cache, card)
    assert allowed == {"esc|", "spz|cuda", "spz-rsort|cuda"}
    on_card = dp._model_select(model, feats, key, "auto", cache, card)
    assert on_card.confident and on_card.combo == "spz|cuda"
    assert not dp.get_engine(on_card.engine).on_host


# ---------------------------------------------------------------------------
# tools/dump_autotune_torch.py against tools/dump_autotune.py
# ---------------------------------------------------------------------------

def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FixedTime:
    @staticmethod
    def time():
        return 1_000_000_000.0


def test_dump_autotune_tool_matches_the_references(tmp_path, capsys,
                                                   monkeypatch):
    ref, port = _tool("dump_autotune"), _tool("dump_autotune_torch")
    for mod in (ref, port):
        monkeypatch.setattr(mod, "time", _FixedTime)
    path = str(tmp_path / "cache.json")
    c = dp.AutotuneCache(path, clock=_FixedTime.time)
    _sweep(c, sizes=(24, 48))
    c.quarantine("bad-bucket", "esc", "torch", reason="boom")

    def run(mod, *argv):
        rc = mod.main(["tool", *argv])
        return rc, capsys.readouterr().out

    for argv in (("show", "--json"), ("show",), ("validate",)):
        assert run(port, *argv, path) == run(ref, *argv, path)
    outs = {}
    for name, mod in (("ref", ref), ("port", port)):
        out = str(tmp_path / f"{name}-ds.json")
        assert run(mod, "export", path, "--output", out)[0] == 0
        outs[name] = json.load(open(out))
    assert outs["ref"] == outs["port"] and outs["port"]["n_samples"] == 2
    copies = {}
    for name, mod in (("ref", ref), ("port", port)):
        copies[name] = str(tmp_path / f"{name}-c.json")
        open(copies[name], "w").write(open(path).read())
        rc, out = run(mod, "compact", copies[name], "--drop-timings")
        assert rc == 0 and "timing vectors stripped" in out
    raw = [json.load(open(copies[n])) for n in ("ref", "port")]
    assert raw[0] == raw[1]
    assert all("timings" not in e for k, e in raw[1].items()
               if not k.startswith("!"))
    bad = {"k": {"source": "autotune", "timings": {"esc|": -1.0}},
           "!quarantine:q": {"combos": "notalist"}}
    json.dump(bad, open(path, "w"))
    assert run(port, "validate", path)[0] == 1
    assert run(port, "validate", path) == run(ref, "validate", path)
    # train: the port fits on the named device and writes the artifact
    c2 = dp.AutotuneCache(str(tmp_path / "c2.json"))
    _sweep(c2, sizes=(24, 48))
    rc, out = run(port, "train", c2.path, "--steps", "40", "--device", "cpu")
    assert rc == 0 and "trained v1 on 2 buckets" in out
    m = dm.DispatchModel.load(c2.path + dp.MODEL_SUFFIX)
    assert m.n_samples == 2 and math.isfinite(m.sigma)
    assert ref_dp.MODEL_SUFFIX == dp.MODEL_SUFFIX
