"""The port's in-process SpGEMM service, plan warmer and serving CLI
against the JAX reference, on the CPU.

On ``make_traffic(24, seed=0)`` under a virtual clock,
``repro_torch.serving.spgemm_service.SpGemmService(devices="cpu")`` must
flush the reference service's buckets for the same reasons, on the same
engine, plan source, tier and lane count, count the same ``stats()``,
and return every result bit for bit; then the same under injected chaos
(kernel faults, a worker kill and failing isolations at a fixed seed):
the same tiers, attempts and dead letters.  The port's ladder on the
CPU is the reference's with ``spz-fused/torch`` in place of
``spz-fused/xla``.  ``PlanWarmer`` must predict, schedule and count as
the reference's on one ``observe`` sequence.

The card rules hold on the CPU too: a kernel that fails to build or
launch raises out of ``drain`` and ``prewarm`` (inline and async), never
retried, degraded or dead-lettered; isolation runs ``esc`` on a card and
``scl-array`` on the CPU.  The CLI serves on a pool of worker processes
(``--workers``).

The reference service runs once per test session, in one fresh process
(both traffic runs), shared by the xdist workers through a lock file, as
in ``tests/test_torch_batched.py``.
"""
import fcntl
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import formats as ref_formats
from repro.serving import plan_warmer as ref_pw
from repro_torch.core import dispatch as dp
from repro_torch.core.formats import csr_to_numpy, random_sparse
from repro_torch.kernels import _build
from repro_torch.kernels import backend as kb
from repro_torch.launch import serve_spgemm as cli
from repro_torch.runtime import faultinject as fi
from repro_torch.distributed import spgemm_shard as shard
from repro_torch.serving import spgemm_service as svc
from repro_torch.serving.plan_warmer import PlanWarmer, neighbor_buckets

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_REQUESTS = 24
DT, TIMEOUT, MAX_BATCH = 0.01, 0.05, 4
# kernel faults at half the batched launches, half the isolations failing
# (dead letters), shard worker 0 killed once; two planned attempts
CHAOS_SEED = 3
STAT_KEYS = ("n_requests", "n_flushes", "n_buckets", "pending",
             "n_dead_letters", "n_warmed", "availability", "n_degraded",
             "degraded_rate", "plan_hit_rate", "flush_hit_rate",
             "warm_hit_rate", "flush_warm_hit_rate", "mean_lanes_per_flush",
             "flush_retry_rate")


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(service, clock, traffic):
    """Submit the traffic one request per DT of virtual time, pumping
    after each, then drain."""
    reqs = []
    for A, B in traffic:
        reqs.append(service.submit(A, B, now=clock.t))
        clock.t += DT
        service.pump(now=clock.t)
    service.drain(now=clock.t)
    return reqs


def _summary(service, reqs):
    """What both packages' runs are compared on (JSON-able)."""
    flushes = [[list(map(list, f.bucket[:2])) + list(f.bucket[2:]),
                f.reason, f.engine, f.source,
                f.tier.replace("/xla", "/torch"), f.n_requests, f.attempts,
                f.n_failed] for f in service.flush_log]
    st = service.stats()
    dead = [[r.id, r.error.stage, r.error.kind] for r in
            service.dead_letters]
    tiers = [[r.id, r.engine, (r.tier or "").replace("/xla", "/torch")]
             for r in reqs if r.result is not None]
    return {"flushes": flushes, "stats": {k: st.get(k) for k in STAT_KEYS},
            "dead": dead, "tiers": tiers}


_REFERENCE_CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[3])
import test_torch_service as T
from repro.core import dispatch as dp
from repro.distributed.spgemm_shard import kill_worker_spec
from repro.launch.serve_spgemm import make_traffic
from repro.runtime import faultinject as fi
from repro.serving.spgemm_service import SpGemmService
from repro.core.formats import csr_to_numpy
out, arrays = {}, {}
for label in ("clean", "chaos"):
    clock = T.VirtualClock()
    policy = dp.RetryPolicy(**T.policy_kw(label))
    service = SpGemmService(max_batch=T.MAX_BATCH, flush_timeout=T.TIMEOUT,
                            cache=dp.AutotuneCache(sys.argv[2] + label),
                            clock=clock, policy=policy)
    traffic = make_traffic(T.N_REQUESTS, seed=0)
    if label == "clean":
        reqs = T._drive(service, clock, traffic)
    else:
        with fi.injected(*T.chaos_specs(fi, kill_worker_spec),
                         seed=T.CHAOS_SEED):
            reqs = T._drive(service, clock, traffic)
    out[label] = T._summary(service, reqs)
    for r in reqs:
        if r.result is not None:
            for f, x in zip(("indptr", "indices", "data"),
                            csr_to_numpy(r.result)):
                arrays[f"{label}:{r.id}:{f}"] = x
np.savez(sys.argv[1] + ".npz", **arrays)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(out, f)
"""


def policy_kw(label):
    return {"sleep": lambda s: None,
            **({"max_attempts": 2} if label == "chaos" else {})}


def chaos_specs(fi_mod, kill_worker_spec):
    return [fi_mod.FaultSpec(site="kernel.batched", rate=0.5),
            fi_mod.FaultSpec(site="dispatch.execute", rate=0.5),
            kill_worker_spec(0)]


@pytest.fixture(scope="session")
def reference(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    out_dir = root / "service-reference"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out_dir / "done"
        if not (done.with_suffix(".json").exists()):
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       PYTHONPATH=os.pathsep.join(
                           [str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")]))
            part = out_dir / "part"
            subprocess.run([sys.executable, "-c", _REFERENCE_CHILD, str(part),
                            str(out_dir / "ref_cache_"),
                            str(ROOT / "tests")],
                           env=env, check=True, timeout=600)
            os.replace(part.with_suffix(".npz"), done.with_suffix(".npz"))
            os.replace(part.with_suffix(".json"), done.with_suffix(".json"))
    return (json.loads(done.with_suffix(".json").read_text()),
            np.load(done.with_suffix(".npz")))


def _run_port(label, tmp_path):
    clock = VirtualClock()
    service = svc.SpGemmService(
        max_batch=MAX_BATCH, flush_timeout=TIMEOUT, devices="cpu",
        cache=dp.AutotuneCache(str(tmp_path / f"{label}.json")),
        clock=clock, policy=dp.RetryPolicy(**policy_kw(label)))
    traffic = cli.make_traffic(N_REQUESTS, seed=0)
    if label == "clean":
        reqs = _drive(service, clock, traffic)
    else:
        with fi.injected(*chaos_specs(fi, shard.kill_worker_spec),
                         seed=CHAOS_SEED):
            reqs = _drive(service, clock, traffic)
    return service, reqs


@pytest.mark.parametrize("label", ["clean", "chaos"])
def test_service_matches_reference(label, reference, tmp_path):
    want, arrays = reference
    service, reqs = _run_port(label, tmp_path)
    got = json.loads(json.dumps(_summary(service, reqs)))
    assert got["flushes"] == want[label]["flushes"]
    assert got["stats"] == want[label]["stats"]
    assert got["dead"] == want[label]["dead"]
    assert got["tiers"] == want[label]["tiers"]
    served = [r for r in reqs if r.result is not None]
    assert len(served) + len(service.dead_letters) == N_REQUESTS
    for r in served:
        assert r.result.device == torch.device("cpu")
        want_csr = [arrays[f"{label}:{r.id}:{f}"]
                    for f in ("indptr", "indices", "data")]
        for w, g in zip(want_csr, csr_to_numpy(r.result)):
            assert w.shape == g.shape and np.array_equal(w, g)
            if g.dtype.kind == "f":
                assert np.array_equal(w.view(np.int32), g.view(np.int32))
    if label == "chaos":  # the run walks every rung
        tiers = {f[4] for f in got["flushes"]}
        assert "planned" in tiers and "isolated" in tiers
        assert any(t.startswith("degraded:") for t in tiers)
        assert got["dead"] and got["stats"]["availability"] < 1.0


def test_make_traffic_is_the_references():
    from repro.launch.serve_spgemm import make_traffic as ref_make_traffic
    for (a, _), (r, _) in zip(cli.make_traffic(12, seed=5),
                              ref_make_traffic(12, seed=5)):
        for x, y in zip(csr_to_numpy(a), ref_formats.csr_to_numpy(r)):
            assert np.array_equal(x, np.asarray(y))
    assert cli.TRAFFIC_MIX == __import__(
        "repro.launch.serve_spgemm", fromlist=["x"]).TRAFFIC_MIX


# ---------------------------------------------------------------------------
# the plan warmer
# ---------------------------------------------------------------------------

def test_plan_warmer_matches_reference():
    """One configure/observe/mark sequence through both warmers: the
    same predictions, due lists, samples kept and stats."""
    mats = [random_sparse(n, n, d, seed=s) for n, d, s in
            ((32, 0.05, 1), (32, 0.06, 2), (48, 0.02, 3), (48, 0.3, 4))]
    ref_mats = [ref_formats.CSR(*(__import__("jax.numpy", fromlist=["x"])
                                  .asarray(x) for x in csr_to_numpy(m)),
                                m.shape) for m in mats]
    trails = []
    for mod, ms in ((ref_pw, ref_mats), (__import__(
            "repro_torch.serving.plan_warmer", fromlist=["x"]), mats)):
        key = (ref_pw if mod is ref_pw else svc).bucket_key
        w = mod.PlanWarmer(configured=[(ms[0], ms[0]),
                                       ((8, 8), (8, 8), 16, 16)],
                           min_count=2, max_warms=6)
        trail = [w.predict(), w.due(), w.stats()]
        for i in (1, 2, 1, 3, 3, 3, 2):
            w.observe(key(ms[i], ms[i]), ms[i], ms[i])
            trail.append(w.due())
        w.mark_pending(trail[1][0])
        w.mark_warmed(trail[1][1])
        w.mark_failed(trail[1][2], "boom")
        trail += [w.predict(), w.due(), w.stats(),
                  w.is_warmed(trail[1][1]),
                  [key(ms[i], ms[i]) for i in range(4)]]
        kept = w.sample(key(ms[3], ms[3]))
        trail.append(int(np.asarray(kept[0].indptr)[-1]))
        trails.append(trail)
    assert trails[0] == trails[1]
    assert neighbor_buckets(((8, 8), (8, 8), 16, 16)) == \
        ref_pw.neighbor_buckets(((8, 8), (8, 8), 16, 16))


# ---------------------------------------------------------------------------
# warming, on the port alone
# ---------------------------------------------------------------------------

def _mat(n=48, density=0.02, seed=0):
    return random_sparse(n, n, density, seed=seed)


@pytest.fixture
def cache(tmp_path):
    return dp.AutotuneCache(str(tmp_path / "autotune.json"))


def test_prewarm_gives_warm_hit_on_first_flush(cache):
    A = _mat(seed=1)
    warmer = PlanWarmer(configured=[(A, A)], neighbors=False)
    service = svc.SpGemmService(cache=cache, max_batch=4, flush_timeout=1e9,
                                devices="cpu", warmer=warmer)
    dp.reset_warm_stats()
    assert service.prewarm() == 1
    assert service.warm_log[-1]["ok"]
    assert warmer.is_warmed(svc.bucket_key(A, A))
    reqs = [service.submit(_mat(seed=s), _mat(seed=s)) for s in (1, 2, 3, 4)]
    assert all(r.done and not r.failed for r in reqs)
    f = service.flush_log[-1]
    assert f.warm_hit and f.tier == "planned" and f.source == "cache"
    assert dp.warm_stats() == {"warmed": 1, "hits": 1, "misses": 0}
    assert service.stats()["warm_hit_rate"] == 1.0


def test_async_warm_and_concurrent_flushes(cache):
    """Two buckets flushing at once on the executor (a barrier inside
    the flush site proves the overlap) land their own results; the pump
    dispatches warm work for an observed bucket."""
    barrier = threading.Barrier(2, timeout=60.0)
    spec = fi.FaultSpec(site="service.flush", kind="call", max_fires=2,
                        action=lambda **ctx: barrier.wait())
    warmer = PlanWarmer(neighbors=False)
    service = svc.SpGemmService(cache=cache, max_batch=2, flush_timeout=1e9,
                                devices="cpu", async_flushes=2,
                                warmer=warmer)
    try:
        with fi.injected(spec):
            ra = [service.submit(_mat(n=32, seed=s), _mat(n=32, seed=s))
                  for s in (1, 2)]
            rb = [service.submit(_mat(n=48, seed=s), _mat(n=48, seed=s))
                  for s in (1, 2)]
            service.drain()
        service.pump()
        service.prewarm(buckets=[], block=True)
        assert warmer.is_warmed(svc.bucket_key(ra[0].A, ra[0].B))
        assert all(r.done and not r.failed for r in ra + rb)
        assert service.pending == 0 and not service.dead_letters
        assert sorted(f.n_requests for f in service.flush_log) == [2, 2]
        for r in ra + rb:
            want = dp.spgemm(r.A, r.B, engine=r.engine, device="cpu")
            for w, g in zip(csr_to_numpy(want), csr_to_numpy(r.result)):
                assert np.array_equal(w, g)
    finally:
        service.close()


# ---------------------------------------------------------------------------
# the card rules, held on the CPU
# ---------------------------------------------------------------------------

def test_isolation_engine_keeps_to_the_device():
    assert svc.isolation_engine("cuda") == "esc"
    assert svc.isolation_engine(torch.device("cuda", 0)) == "esc"
    assert svc.isolation_engine("cpu") == "scl-array"
    assert dp.degrade_chain("cuda")[-1] == ("esc", None)


@pytest.mark.parametrize("error", [_build.KernelBuildError,
                                   _build.KernelLaunchError])
@pytest.mark.parametrize("async_flushes", [0, 2])
def test_kernel_errors_raise_out_of_drain(error, async_flushes, cache,
                                          monkeypatch):
    """A batched driver that raises a kernel error: drain raises it
    (inline, and from the flush thread), after one attempt, with nothing
    degraded, dead-lettered or quarantined."""
    calls = []

    def broken(A, B, **kw):
        calls.append(1)
        raise error("synthetic kernel fault")
    for name in list(dp._BATCH_DRIVERS):
        monkeypatch.setitem(dp._BATCH_DRIVERS, name, broken)
    service = svc.SpGemmService(cache=cache, max_batch=8, flush_timeout=1e9,
                                devices="cpu", async_flushes=async_flushes,
                                policy=dp.RetryPolicy(sleep=lambda s: None))
    try:
        reqs = [service.submit(_mat(seed=s), _mat(seed=s)) for s in (1, 2)]
        with pytest.raises(error):
            service.drain()
        assert len(calls) == 1
        assert not service.dead_letters and not service.flush_log
        assert not any(r.done for r in reqs)
        assert not any(k.startswith("!quarantine:")
                       for k in cache.entries())
    finally:
        service.close()


@pytest.mark.parametrize("async_flushes", [0, 2])
def test_kernel_errors_raise_out_of_prewarm(async_flushes, cache,
                                            monkeypatch):
    def broken(*a, **kw):
        raise _build.KernelBuildError("synthetic build fault")
    monkeypatch.setattr(dp, "warm_bucket", broken)
    A = _mat(seed=1)
    warmer = PlanWarmer(configured=[(A, A)], neighbors=False)
    service = svc.SpGemmService(cache=cache, max_batch=4, devices="cpu",
                                async_flushes=async_flushes, warmer=warmer)
    try:
        with pytest.raises(_build.KernelBuildError):
            service.prewarm()
        assert not service.warm_log
    finally:
        service.close()


def test_injected_faults_still_walk_the_ladder(cache):
    """An injected fault (not a kernel error) degrades as in the
    reference: here down the CPU's chain to spz-fused/torch."""
    service = svc.SpGemmService(cache=cache, max_batch=2, flush_timeout=1e9,
                                devices="cpu", engine="esc",
                                policy=dp.RetryPolicy(sleep=lambda s: None))
    with fi.injected(fi.FaultSpec(site="kernel.batched",
                                  match={"engine": "esc"})):
        reqs = [service.submit(_mat(seed=s), _mat(seed=s)) for s in (1, 2)]
    f = service.flush_log[-1]
    assert f.tier == "degraded:spz-fused/torch" and f.attempts == 4
    assert all(r.done and not r.failed for r in reqs)
    assert kb.KERNEL_ERRORS and not issubclass(fi.InjectedFault,
                                               kb.KERNEL_ERRORS)


def test_cli_serves_on_a_worker_pool(tmp_path, capsys, monkeypatch):
    """``--workers 2 --verify`` on the CPU: two spawned workers serve
    every request, each result checked against the scl-array oracle
    (within 120 s, or SIGALRM fails the test).  ``--async-flushes`` with
    ``--workers`` is refused before any worker starts."""
    with pytest.raises(SystemExit) as refused:
        cli.run(["--device", "cpu", "--workers", "2", "--async-flushes",
                 "2"])
    assert refused.value.code == 2
    assert "exclude each other" in capsys.readouterr().err
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned workers'

    def overdue(*_):
        raise TimeoutError("the worker-pool CLI run took over 120 s")
    old = signal.signal(signal.SIGALRM, overdue)
    signal.alarm(120)
    try:
        res = cli.run(["--device", "cpu", "--requests", "12", "--max-batch",
                       "4", "--workers", "2", "--verify", "--cache",
                       str(tmp_path / "c.json")])
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert res["all"]["n_requests"] == 12 and res["all"]["availability"] == 1
    assert [e["event"] for e in res["pool"]["events"]] == ["spawn"] * 2
    assert res["pool"]["alive"] == 2 and res["pool"]["start_s"] > 0
    assert all(r.result.device == torch.device("cpu")
               for r in res["service"].completed)
    out = capsys.readouterr().out
    assert "verified 12 results" in out
    assert "# pool: 2 workers, 2 alive at drain | events: spawnx2" in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert svc.SpGemmService().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.SpGemmService()


# ---------------------------------------------------------------------------
# the CLI, in process
# ---------------------------------------------------------------------------

def test_cli_serves_and_verifies_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--requests", "24", "--max-batch", "4",
            "--verify", "--cache", str(tmp_path / "c.json")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "verified 24 results" in out and "p99=" in out
    res = cli.run(argv + ["--warm", "--async-flushes", "2",
                          "--inject-rate", "0.2", "--kill-worker", "0"])
    service = res["service"]
    assert res["all"]["n_requests"] + res["all"]["n_dead_letters"] == 24
    assert res["all"]["availability"] == 1.0
    assert res["all"]["n_warmed"] > 0 and res["warm_s"] > 0
    assert any(f.warm_hit for f in service.flush_log)
    out = capsys.readouterr().out
    assert "chaos: availability=1.0000" in out
    assert "warm_hit_rate=" in out
