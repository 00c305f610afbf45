"""The port's lane-sharded batched SpGEMM and warm layer against the JAX
reference, on the CPU.

``repro_torch.distributed.spgemm_shard`` must assign lanes exactly as
``repro.distributed.spgemm_shard`` does (the same LPT pass and
tie-breaks), and ``execute_sharded`` on a list of four CPU "devices" must
give, lane by lane, the reference's ``execute_sharded`` on four XLA CPU
devices and the port's own ``execute_batched`` bit for bit (-0.0
included), for ``spz``, ``spz-rsort``, ``spz-host`` and ``esc``, also
when shard worker 1 is killed and its lanes re-run; an unrecovered loss
raises ``WorkerLost``.  The warm layer's synthetic operands are the
reference's arrays, and ``warm_bucket`` picks the reference's engine,
source and esc capacity and moves the warm counters as it does.

The reference runs once per test session, in one fresh process with
four XLA host devices (XLA's CPU compiler keeps every compiled shape
mapped for the life of a process), shared by the xdist workers through a
lock file, as in ``tests/test_torch_batched.py``.
"""
import dataclasses
import fcntl
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.distributed import spgemm_shard as ref_shard
from repro_torch.core import dispatch as dp
from repro_torch.core import spgemm_engines as sg
from repro_torch.core.formats import batch_csr, csr_to_numpy, random_sparse
from repro_torch.distributed import spgemm_shard as shard
from repro_torch.runtime import faultinject as fi

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPUS = ["cpu"] * 4
ENGINES = ("spz", "spz-rsort", "spz-host", "esc")
# (bucket, engine, sticky_cap) of the warm-layer cases
WARM_CASES = [(((64, 64), (64, 64), 256, 256), "auto", None),
              (((64, 64), (64, 64), 256, 256), "esc", 4096),
              (((96, 96), (96, 96), 16, 16), "auto", None),
              (((128, 128), (128, 128), 512, 512), "spz", None)]


def _mixed_batch(seed=0):
    """The reference's ``tests/test_shard_spgemm.py`` batch: mixed
    densities and patterns, very skewed per-lane work."""
    specs = [(0.004, "uniform"), (0.05, "uniform"), (0.02, "powerlaw"),
             (0.03, "banded"), (0.01, "uniform"), (0.04, "powerlaw")]
    return [random_sparse(64, 64, d, seed=seed + i, pattern=p)
            for i, (d, p) in enumerate(specs)]


def _kw(engine):
    return {"R": 8, "S": 32} if engine.startswith("spz") else {}


def _assert_bits(want, got):
    for w, g in zip(want, got):
        assert w.shape == g.shape and np.array_equal(w, g)
        if g.dtype.kind == "f":
            assert np.array_equal(w.view(np.int32), g.view(np.int32))


def _assert_batched_equal(a, b):
    assert a.valid.tolist() == b.valid.tolist()
    for i in range(a.batch):
        _assert_bits(csr_to_numpy(a[i]), csr_to_numpy(b[i]))


@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


# ---------------------------------------------------------------------------
# the reference, once per session
# ---------------------------------------------------------------------------

_REFERENCE_CHILD = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import dispatch as dp
from repro.core.formats import CSR, batch_csr, csr_to_numpy
from repro.distributed import spgemm_shard as shard
from repro.runtime import faultinject as fi
assert len(jax.devices()) == 4
z = np.load(sys.argv[1])
n, shape = int(z["n"]), tuple(int(x) for x in z["shape"])
mats = [CSR(jnp.asarray(z[f"indptr{i}"]), jnp.asarray(z[f"indices{i}"]),
            jnp.asarray(z[f"data{i}"]), shape) for i in range(n)]
A = batch_csr(mats, batch_cap=8)
cache = dp.AutotuneCache(sys.argv[3])
res = {}

def put(prefix, out):
    res[prefix + "valid"] = np.asarray(out.valid)
    for i in range(out.batch):
        for f, x in zip(("indptr", "indices", "data"), csr_to_numpy(out[i])):
            res[f"{prefix}{f}{i}"] = x

res["works"] = shard.lane_works(A, A)
for engine in ("spz", "spz-rsort", "spz-host", "esc"):
    kw = {"R": 8, "S": 32} if engine.startswith("spz") else {}
    sp = shard.plan_sharded(A, A, engine, cache=cache, **kw)
    res[engine + ":slots"] = np.asarray(sp.slot_of_lane)
    res[engine + ":loads"] = np.asarray(sp.device_loads())
    res[engine + ":layout"] = np.asarray([sp.n_dev, sp.lanes_per_dev])
    res[engine + ":cap"] = np.asarray(
        sp.base.kwargs_dict.get("cap_products", -1))
    put(engine + ":", shard.execute_sharded(sp, A, A))
    with fi.injected(shard.kill_worker_spec(1)) as inj:
        put(engine + ":killed:", shard.execute_sharded(sp, A, A))
    res[engine + ":events"] = np.asarray(
        [[e["call"], e["device"]] for e in inj.events])
    kill_all = fi.FaultSpec(
        site="shard.worker", max_fires=None,
        exc_factory=lambda site, ctx: shard.WorkerLost(ctx["device"]))
    try:
        with fi.injected(kill_all):
            shard.execute_sharded(sp, A, A)
        res[engine + ":unrecovered"] = np.asarray(0)
    except shard.WorkerLost:
        res[engine + ":unrecovered"] = np.asarray(1)
warm = [(((64, 64), (64, 64), 256, 256), "auto", None),
        (((64, 64), (64, 64), 256, 256), "esc", 4096),
        (((96, 96), (96, 96), 16, 16), "auto", None),
        (((128, 128), (128, 128), 512, 512), "spz", None)]
dp.reset_warm_stats()
for k, (bucket, engine, sticky) in enumerate(warm):
    a, b = dp.synthetic_bucket_operands(bucket)
    for side, m in (("a", a), ("b", b)):
        for f, x in zip(("indptr", "indices", "data"), csr_to_numpy(m)):
            res[f"warm{k}:{side}{f}"] = x
    before = dp.warm_stats()
    w = dp.warm_bucket(bucket, engine=engine, max_batch=4, sticky_cap=sticky,
                       cache=dp.AutotuneCache(sys.argv[3] + f".warm{k}"))
    res[f"warm{k}:engine"] = np.asarray(w["engine"])
    res[f"warm{k}:source"] = np.asarray(w["source"])
    res[f"warm{k}:cap"] = np.asarray(-1 if w["cap"] is None else w["cap"])
    res[f"warm{k}:stats"] = np.asarray([before["warmed"],
                                        dp.warm_stats()["warmed"]])
res["warm:stats"] = np.asarray(list(dp.warm_stats().values()))
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out_dir = root / "shard-reference"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out_dir / "done.npz"
        if not done.exists():
            mats = _mixed_batch()
            arrays = {"n": len(mats), "shape": np.array(mats[0].shape)}
            for i, m in enumerate(mats):
                for f, x in zip(("indptr", "indices", "data"),
                                csr_to_numpy(m)):
                    arrays[f"{f}{i}"] = x
            np.savez(out_dir / "in.npz", **arrays)
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join(
                           [str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")]))
            subprocess.run([sys.executable, "-c", _REFERENCE_CHILD,
                            str(out_dir / "in.npz"), str(out_dir / "o.npz"),
                            str(out_dir / "ref_cache.json")],
                           env=env, check=True, timeout=600)
            os.replace(out_dir / "o.npz", done)
    return np.load(done)


def _ref_lanes(ref, prefix, batch=8):
    return ref[prefix + "valid"].tolist(), [
        [ref[f"{prefix}{f}{i}"] for f in ("indptr", "indices", "data")]
        for i in range(batch)]


# ---------------------------------------------------------------------------
# assignment, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_assign_lanes_matches_reference(n_dev):
    """The reference's ``tests/test_shard_spgemm.py`` cases: zipf works
    over 2, 4 and 8 devices and the slot-capped [5..0] over 3."""
    works = np.random.default_rng(0).zipf(1.5, 64) * 100
    if n_dev == 3:
        works = np.array([5, 4, 3, 2, 1, 0])
    got = shard.assign_lanes(works, n_dev)
    assert np.array_equal(got, ref_shard.assign_lanes(works, n_dev))
    counts = np.bincount(got, minlength=n_dev)
    assert counts.max() <= -(-len(works) // n_dev)
    loads = np.bincount(got, weights=works, minlength=n_dev)
    assert loads.max() <= works.sum() / n_dev + works.max()


def test_lane_devices():
    assert shard.lane_devices("cpu") == (torch.device("cpu"),)
    assert shard.lane_devices(CPUS) == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="at least one"):
        shard.lane_devices([])
    if torch.cuda.is_available():
        assert shard.lane_devices()[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard.lane_devices()


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_shard_plan_matches_reference(engine, reference, cache):
    A = batch_csr(_mixed_batch(), batch_cap=8)
    assert np.array_equal(shard.lane_works(A, A), reference["works"])
    sp = shard.plan_sharded(A, A, engine, devices=CPUS, cache=cache,
                            **_kw(engine))
    assert sp.devices == (torch.device("cpu"),) * 4
    assert list(sp.slot_of_lane) == reference[engine + ":slots"].tolist()
    assert sp.device_loads() == reference[engine + ":loads"].tolist()
    assert [sp.n_dev, sp.lanes_per_dev] == \
        reference[engine + ":layout"].tolist()
    assert sum(sp.device_loads()) == sum(sp.works)
    assert sp.base.kwargs_dict.get("cap_products", -1) == \
        int(reference[engine + ":cap"])


@pytest.mark.parametrize("engine", ENGINES)
def test_execute_sharded_matches_reference(engine, reference, cache):
    """Four CPU devices, two padding lanes: the reference's sharded lanes
    and the port's execute_batched on the same base plan, bit for bit;
    then with shard worker 1 killed once (its lanes re-run on device 0,
    at the reference's call index); then with every worker dead, which
    raises."""
    A = batch_csr(_mixed_batch(), batch_cap=8)
    sp = shard.plan_sharded(A, A, engine, devices=CPUS, cache=cache,
                            **_kw(engine))
    got = shard.execute_sharded(sp, A, A)
    _assert_batched_equal(dp.execute_batched(sp.base, A, A), got)
    valid, lanes = _ref_lanes(reference, engine + ":")
    assert got.valid.tolist() == valid == [True] * 6 + [False] * 2
    for i, want in enumerate(lanes):
        _assert_bits(want, csr_to_numpy(got[i]))
    with fi.injected(shard.kill_worker_spec(1)) as inj:
        killed = shard.execute_sharded(sp, A, A)
    assert [[e["call"], e["device"]] for e in inj.events] == \
        reference[engine + ":events"].tolist()
    _assert_batched_equal(got, killed)
    valid, lanes = _ref_lanes(reference, engine + ":killed:")
    assert killed.valid.tolist() == valid
    for i, want in enumerate(lanes):
        _assert_bits(want, csr_to_numpy(killed[i]))
    kill_all = fi.FaultSpec(
        site="shard.worker", max_fires=None,
        exc_factory=lambda site, ctx: shard.WorkerLost(ctx["device"]))
    assert int(reference[engine + ":unrecovered"]) == 1
    with fi.injected(kill_all), pytest.raises(shard.WorkerLost,
                                              match="unrecovered"):
        shard.execute_sharded(sp, A, A)


@pytest.mark.parametrize("k", range(len(WARM_CASES)))
def test_warm_bucket_matches_reference(k, reference, tmp_path):
    bucket, engine, sticky = WARM_CASES[k]
    a, b = dp.synthetic_bucket_operands(bucket)
    for side, m in (("a", a), ("b", b)):
        _assert_bits([reference[f"warm{k}:{side}{f}"]
                      for f in ("indptr", "indices", "data")],
                     csr_to_numpy(m))
    dp.reset_warm_stats()
    w = dp.warm_bucket(bucket, engine=engine, max_batch=4, sticky_cap=sticky,
                       devices="cpu",
                       cache=dp.AutotuneCache(str(tmp_path / "w.json")))
    assert w["bucket"] == bucket and w["wall_s"] > 0.0
    assert (w["engine"], w["source"]) == (str(reference[f"warm{k}:engine"]),
                                          str(reference[f"warm{k}:source"]))
    assert (-1 if w["cap"] is None else w["cap"]) == \
        int(reference[f"warm{k}:cap"])
    assert dp.warm_stats() == {"warmed": 1, "hits": 0, "misses": 0}
    assert int(np.diff(reference[f"warm{k}:stats"])[0]) == 1


def test_warm_counters_move_as_the_references():
    """note_warmed / jit_warmed / warm_stats / reset_warm_stats: the
    reference's counters on the same sequence of calls."""
    from repro.core import dispatch as ref_dp
    seen = []
    for mod in (ref_dp, dp):
        mod.reset_warm_stats()
        mod.note_warmed(("k", 1))
        trail = [mod.jit_warmed(("k", 1)), mod.jit_warmed(("k", 2)),
                 mod.jit_warmed(("k", 2), count=False), mod.warm_stats()]
        mod.reset_warm_stats()
        seen.append(trail + [mod.warm_stats()])
    assert seen[0] == seen[1]
    assert seen[1][3] == {"warmed": 1, "hits": 1, "misses": 1}


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------

def _straddling_batch():
    """48-row lanes at S = 32: the unsplit batch's second lock-step group
    holds rows of lanes 0 and 1, and every split by device cuts it."""
    return [random_sparse(48, 48, d, seed=40 + i, pattern=p)
            for i, (d, p) in enumerate([(0.05, "uniform"), (0.03, "powerlaw"),
                                        (0.04, "banded"), (0.02, "uniform")])]


FIELDS = ("n_mssort", "sort_elems", "n_mszip", "zip_elems", "chunk_loads",
          "chunk_stores")


@pytest.mark.parametrize("engine", ["spz", "spz-rsort", "spz-host"])
def test_split_inside_a_group_keeps_bits_and_counters(engine, cache):
    """A split that cuts inside a shared lock-step group gives every
    lane its single call's CSR; with one device the flush's six counters
    are execute_batched's, with four the per-stream sums (sort_elems,
    zip_elems) are too and the issue counts are the device groups' own
    batched calls, summed."""
    mats = _straddling_batch()
    A = batch_csr(mats)
    kw = {"R": 8, "S": 32}
    one = shard.plan_sharded(A, A, engine, devices="cpu", cache=cache, **kw)
    want, want_st = dp.execute_batched(one.base, A, A, return_stats=True)
    got, st = shard.execute_sharded(one, A, A, return_stats=True)
    _assert_batched_equal(want, got)
    assert [getattr(st, f) for f in FIELDS] == \
        [getattr(want_st, f) for f in FIELDS]
    four = shard.plan_sharded(A, A, engine, devices=CPUS, cache=cache, **kw)
    got4, st4 = shard.execute_sharded(four, A, A, return_stats=True)
    _assert_batched_equal(want, got4)
    for i, m in enumerate(mats):
        single = dp.spgemm(m, m, engine=engine, device="cpu", **kw)
        _assert_bits(csr_to_numpy(single), csr_to_numpy(got4[i]))
    assert (st4.sort_elems, st4.zip_elems) == \
        (want_st.sort_elems, want_st.zip_elems)
    parts = sg.SpzStats()
    for i in range(len(mats)):  # one lane per device
        sub = batch_csr([mats[i]])
        p = dp.plan_batched(sub, sub, engine, device="cpu", cache=cache, **kw)
        shard.add_stats(parts, dp.execute_batched(p, sub, sub,
                                                  return_stats=True)[1])
    assert [getattr(st4, f) for f in FIELDS] == \
        [getattr(parts, f) for f in FIELDS]
    assert st4.n_mssort != want_st.n_mssort  # the split did cut a group


def test_execute_batched_stats_equal_single_call_stats(cache):
    """One valid lane: the batched call counts what spgemm counts."""
    m = _straddling_batch()[1]
    b = batch_csr([m], batch_cap=2)
    for engine in ("spz", "spz-host", "esc"):
        kw = _kw(engine)
        p = dp.plan_batched(b, b, engine, device="cpu", cache=cache, **kw)
        out, st = dp.execute_batched(p, b, b, return_stats=True)
        single, want = dp.spgemm(m, m, engine=engine, device="cpu",
                                 return_stats=True, **kw) \
            if engine != "esc" else (dp.spgemm(m, m, engine="esc",
                                               device="cpu"), None)
        _assert_bits(csr_to_numpy(single), csr_to_numpy(out[0]))
        if want is None:
            assert st is None
        else:
            assert [getattr(st, f) for f in FIELDS] == \
                [getattr(want, f) for f in FIELDS]


def test_sharded_rejects_mismatched_operands(cache):
    A = batch_csr(_mixed_batch())
    B = batch_csr(_mixed_batch()[:3])
    sp = shard.plan_sharded(A, A, "esc", devices=CPUS, cache=cache)
    with pytest.raises(ValueError, match="mismatch"):
        shard.execute_sharded(sp, B, B)
    dead = dataclasses.replace(A, valid=torch.zeros_like(A.valid))
    with pytest.raises(ValueError, match="no valid lanes"):
        shard.execute_sharded(sp, dead, dead)


def test_one_device_worker_loss_has_no_survivor(cache):
    """One device: a killed worker leaves no survivor, so the loss
    raises (the service ladder takes over), as in the reference."""
    A = batch_csr(_mixed_batch())
    for engine in ("esc", "spz"):
        sp = shard.plan_sharded(A, A, engine, devices="cpu", cache=cache,
                                **_kw(engine))
        with fi.injected(shard.kill_worker_spec(0)), \
                pytest.raises(shard.WorkerLost, match="unrecovered"):
            shard.execute_sharded(sp, A, A)
