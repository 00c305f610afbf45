"""The port's worker-process coordinator (``repro_torch.runtime.
coordinator``, ``runtime/elastic.remesh_lanes``) and the service's remote
half, on the CPU.

Against the JAX reference, in process and on the same inputs: the lane
partition over a grid of (lanes, workers); the rendezvous scores; the
flush payload's arrays and fields (the port's ``RetryPolicy.fallback=
None`` travels as None); pack/unpack (``-0.0`` and dtypes kept); and a
routing trace — both coordinators' ``_dispatch``/``_drain_queue``/
``_on_worker_lost`` on stub workers (no spawn), fed the same submits and
completions, route every task to the same worker and hold the same queue
and the same events.

Then real spawned pools of ``"cpu"`` workers (SIGKILLs are real): the
CLI's traffic served by a 2-worker pool equals the in-process port
service's results bit for bit (``tests/test_torch_service.py`` holds the
in-process service against the reference); a worker SIGKILLed
mid-flush costs no request; a hung worker is reaped at a short
``task_timeout_s``; a quarantine pushed by one worker routes the other
around the combo; a lost pool falls back to the local ladder; a worker
killed mid-warm costs no request; and an injected ``KernelLaunchError``
in a worker raises out of the parent's ``drain``, naming the worker, and
is not re-run anywhere.  Every spawn-based test runs under a SIGALRM
deadline of its own.
"""
import collections
import contextlib
import signal

import numpy as np
import pytest
import torch

from repro.core import dispatch as ref_dp
from repro.core import formats as ref_formats
from repro.runtime import coordinator as ref_coord
from repro.runtime import elastic as ref_elastic
from repro_torch.core import dispatch as dp
from repro_torch.core.formats import CSR, csr_to_numpy, random_sparse
from repro_torch.kernels import _build
from repro_torch.launch import serve_spgemm as cli
from repro_torch.runtime import coordinator as coord
from repro_torch.runtime import elastic
from repro_torch.runtime import faultinject as fi
from repro_torch.serving import spgemm_service as svc
from repro_torch.serving.plan_warmer import PlanWarmer

torch.set_num_threads(2)

N_TRAFFIC = 40
SPAWN_DEADLINE_S = 120


@contextlib.contextmanager
def deadline(seconds=SPAWN_DEADLINE_S):
    """Fail the test (TimeoutError) if its spawned pool outlives it."""
    def overdue(*_):
        raise TimeoutError(f"spawn-based test exceeded {seconds} s")
    old = signal.signal(signal.SIGALRM, overdue)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _bits(m):
    return [x.view(np.int32) if x.dtype.kind == "f" else x
            for x in csr_to_numpy(m)]


def _equal(a, b) -> bool:
    return all(x.shape == y.shape and np.array_equal(x, y)
               for x, y in zip(_bits(a), _bits(b)))


def _pool(tmp_path, n=2, name="pool.json", **kw):
    kw.setdefault("start_timeout_s", 60.0)
    return coord.ProcessCoordinator(n, devices=["cpu"],
                                    cache_path=str(tmp_path / name), **kw)


def _service(cache_path, coordinator=None, **kw):
    return svc.SpGemmService(
        max_batch=4, flush_timeout=1e9, devices="cpu",
        cache=dp.AutotuneCache(cache_path), coordinator=coordinator,
        policy=dp.RetryPolicy(max_attempts=5, backoff_base_s=0.0), **kw)


def _serve(service, traffic, timeout=90.0):
    reqs = [service.submit(A, B) for A, B in traffic]
    service.drain(timeout=timeout)
    return reqs


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit this environment: one intra-op thread
    each, so that a pool does not crowd the other test processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def traffic():
    return cli.make_traffic(N_TRAFFIC, seed=0)


@pytest.fixture(scope="module")
def inline_run(traffic, tmp_path_factory):
    """The in-process port service on the same traffic: the oracle every
    pool run is held to, bit for bit."""
    path = str(tmp_path_factory.mktemp("inline") / "autotune.json")
    service = _service(path)
    reqs = _serve(service, traffic)
    assert not service.dead_letters and all(r.done for r in reqs)
    return {r.id: r for r in reqs}


# ---------------------------------------------------------------------------
# against the reference, in process
# ---------------------------------------------------------------------------

def test_remesh_lanes_matches_the_reference():
    for lanes in range(1, 10):
        for workers in range(1, 12):
            assert elastic.remesh_lanes(lanes, workers) == \
                ref_elastic.remesh_lanes(lanes, workers)
    for bad in ((0, 2), (2, 0)):
        for mod in (elastic, ref_elastic):
            with pytest.raises(ValueError):
                mod.remesh_lanes(*bad)


def test_hrw_matches_the_reference():
    buckets = [repr(((n, n), (n, n), c, c)) for n in (32, 64, 96, 128)
               for c in (16, 64, 1024, 1 << 20)] + ["x", ""]
    for b in buckets:
        for w in range(16):
            assert coord._hrw(b, w) == ref_coord._hrw(b, w)


class _Req:
    def __init__(self, A, B):
        self.A, self.B = A, B


def _ref_csr(m):
    import jax.numpy as jnp
    return ref_formats.CSR(*(jnp.asarray(x) for x in
                             (m.indptr.numpy(), m.indices.numpy(),
                              m.data.numpy())), m.shape)


def test_flush_payload_matches_the_reference():
    mats = [random_sparse(n, n, 0.05, seed=s) for n, s in ((32, 1), (40, 2))]
    bucket = svc.bucket_key(mats[0], mats[0])
    kw = dict(max_attempts=7, backoff_base_s=0.125, backoff_factor=3.0)
    fallback = (("spz-fused", "torch"), ("esc", None))
    got = coord.make_flush_payload(
        [_Req(m, m) for m in mats], bucket=bucket, engine="auto",
        max_batch=4, policy=dp.RetryPolicy(fallback=fallback, **kw))
    want = ref_coord.make_flush_payload(
        [_Req(_ref_csr(m), _ref_csr(m)) for m in mats], bucket=bucket,
        engine="auto", max_batch=4,
        policy=ref_dp.RetryPolicy(fallback=fallback, **kw))
    assert {k: v for k, v in got.items() if k != "pairs"} == \
        {k: v for k, v in want.items() if k != "pairs"}
    for gp, wp in zip(got["pairs"], want["pairs"]):
        for g, w in zip(gp, wp):
            assert g[3] == w[3]
            for x, y in zip(g[:3], w[:3]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    # the port's default policy: fallback=None ("the device's chain")
    # travels as None and comes back as None in the worker's policy
    p = coord.make_flush_payload([_Req(mats[0], mats[0])], bucket=bucket,
                                 engine="auto", max_batch=4,
                                 policy=dp.RetryPolicy())
    assert p["policy"]["fallback"] is None
    assert dp.RetryPolicy(**p["policy"]).fallback is None
    assert "policy" not in coord.make_flush_payload(
        [], bucket=bucket, engine="esc", max_batch=2)


def test_pack_unpack_keeps_bits_and_dtypes():
    m = random_sparse(24, 24, 0.1, seed=3)
    data = m.data.clone()
    data[0], data[1] = -0.0, float("inf")
    m = CSR(m.indptr, m.indices, data, m.shape)
    t = coord.pack_csr(m)
    assert all(isinstance(x, np.ndarray) for x in t[:3]) and t[3] == m.shape
    back = coord.unpack_csr(t, "cpu")
    for a, b in zip((m.indptr, m.indices, m.data),
                    (back.indptr, back.indices, back.data)):
        assert a.dtype == b.dtype and b.device == torch.device("cpu")
        assert np.array_equal(a.numpy().view(np.int32),
                              b.numpy().view(np.int32))
    assert np.signbit(back.data[0].item())
    # the packed arrays are copies: the result does not alias the request
    t[2][2] = 7.0
    assert m.data[2].item() != 7.0


class _StubConn:
    def __init__(self, wid, log):
        self.wid, self.log = wid, log

    def send(self, msg):
        self.log.append([self.wid, msg[0]] + ([msg[1]] if msg[0] != "stop"
                                              else []))

    def close(self):
        self.log.append([self.wid, "close"])


def _stub_pool(mod, n_workers=3, n_lanes=4):
    pc = mod.ProcessCoordinator.__new__(mod.ProcessCoordinator)
    pc.n_lanes, pc.affinity_spill = n_lanes, 2
    pc.max_worker_restarts, pc.max_task_retries = 0, 1
    pc.task_timeout_s, pc.events = None, []
    pc._queue, pc._next_task = collections.deque(), 0
    pc._workers = [mod._Worker(i) for i in range(n_workers)]
    log = []
    for w in pc._workers:
        w.alive, w.conn = True, _StubConn(w.id, log)
    return pc, log


def _routing_trace(mod):
    """A fixed script of submits, completions, a loss and queue scans."""
    pc, log = _stub_pool(mod)
    buckets = [((n, n), (n, n), c, c) for n, c in
               ((64, 16), (64, 256), (96, 128), (128, 512), (128, 1024))]
    trace = []

    def snap(label):
        trace.append([label, [t.id for t in pc._queue],
                      {w.id: sorted(w.in_flight) for w in pc._workers},
                      list(log)])
        log.clear()

    def finish(tid):
        out = []
        for w in pc._workers:
            if tid in w.in_flight:
                pc._handle(w, ("result", tid, {"ok": tid}), out)
        return out

    for i in range(12):
        payload = {"bucket": buckets[(i * 7) % 5]} if i % 4 else {}
        pc.submit(payload)
        snap(f"submit {i}")
    for tid in (0, 3, 5):
        trace.append(["finish", tid, finish(tid)])
        pc._drain_queue()
        snap(f"drain after {tid}")
    out = []
    pc._on_worker_lost(pc._workers[1], "pipe EOF (exit -9)", out)
    trace.append(["lost", out])
    snap("lost 1")
    for i in range(4):
        pc.submit({"bucket": buckets[i]}, prefer=2 if i == 3 else None)
        snap(f"late submit {i}")
    for tid in sorted({t for w in pc._workers for t in w.in_flight}):
        trace.append(["finish", tid, finish(tid)])
        pc._drain_queue()
        snap(f"drain after {tid}")
    return trace, pc.events


def test_routing_trace_matches_the_reference():
    got, got_events = _routing_trace(coord)
    want, want_events = _routing_trace(ref_coord)
    assert got == want
    assert got_events == want_events
    names = [e["event"] for e in got_events]
    assert names == ["worker_lost", "remesh"]


# ---------------------------------------------------------------------------
# spawned pools on the CPU
# ---------------------------------------------------------------------------

def test_pool_serves_the_cli_traffic_bit_for_bit(tmp_path, traffic,
                                                 inline_run):
    with deadline(), _pool(tmp_path) as pool:
        service = _service(pool.cache_path, coordinator=pool)
        reqs = _serve(service, traffic)
        assert pool.alive_count == 2
    assert not service.dead_letters and service.pending == 0
    for r in reqs:
        want = inline_run[r.id]
        assert r.done and r.tier == want.tier == "planned"
        assert r.engine == want.engine, r.id
        assert r.result.device == torch.device("cpu")
        assert _equal(r.result, want.result), r.id
    assert all(f.engine not in ("?", None) and f.launches == {}
               for f in service.flush_log)
    spawns = [e for e in pool.events if e["event"] == "spawn"]
    assert [e["worker"] for e in spawns] == [0, 1]
    assert all(e["n_lanes"] == 1 for e in spawns)


def test_sigkill_mid_flush_keeps_availability(tmp_path, traffic,
                                              inline_run):
    """Worker 0 SIGKILLed inside its first flush while 10% of batched
    launches fail in both workers: every id resolves, availability 1.0,
    planned results bit for bit the in-process run's, and the
    reference's sequence: worker_lost (with the orphaned task), the
    respawn, restart, remesh."""
    chaos = fi.FaultSpec(site="kernel.batched", kind="raise", rate=0.10)
    specs = {0: [fi.FaultSpec(site="service.flush", kind="kill_process",
                              max_fires=1), chaos], 1: [chaos]}
    with deadline(), _pool(tmp_path, fault_specs=specs, fault_seed=11,
                           max_worker_restarts=1) as pool:
        service = _service(pool.cache_path, coordinator=pool)
        reqs = _serve(service, traffic[:16])
        events = list(pool.events)
    assert all(r.done and (r.result is None) != (r.error is None)
               for r in reqs)
    assert service.stats()["availability"] == 1.0
    for r in reqs:
        want = inline_run[r.id].result
        if r.tier == "planned":
            assert _equal(r.result, want), r.id
        else:
            np.testing.assert_allclose(r.result.to_dense().numpy(),
                                       want.to_dense().numpy(),
                                       rtol=1e-4, atol=1e-4)
    names = [e["event"] for e in events]
    i = names.index("worker_lost")
    lost = events[i]
    assert lost["worker"] == 0 and lost["orphans"]
    assert "pipe EOF" in lost["why"]
    assert names[i + 1:i + 4] == ["spawn", "restart", "remesh"]
    assert events[i + 2] == {"event": "restart", "worker": 0, "n": 1}


def test_hung_worker_is_reaped_and_its_task_rerun(tmp_path):
    specs = {0: [fi.FaultSpec(site="service.flush", kind="hang",
                              delay_s=120.0, max_fires=1)]}
    m = random_sparse(32, 32, 0.02, seed=0)
    payload = {"bucket": svc.bucket_key(m, m),
               "pairs": [(coord.pack_csr(m), coord.pack_csr(m))],
               "engine": "auto", "max_batch": 4,
               "policy": {"max_attempts": 2, "backoff_base_s": 0.0}}
    with deadline(), _pool(tmp_path, fault_specs=specs,
                           max_worker_restarts=0,
                           task_timeout_s=3.0) as pool:
        tid = pool.submit(payload, prefer=0)
        res = _wait(pool, tid)
        lost = [e for e in pool.events if e["event"] == "worker_lost"]
        assert pool.alive_count == 1
    assert res["outcomes"] and all(o["ok"] for o in res["outcomes"])
    assert lost == [{"event": "worker_lost", "worker": 0,
                     "why": "task timeout", "orphans": [tid]}]
    want = dp.spgemm(m, m, engine=res["outcomes"][0]["engine"], device="cpu")
    assert _equal(coord.unpack_csr(res["outcomes"][0]["result"], "cpu"), want)


def _wait(pool, task_id, timeout=60.0):
    import time
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        for tid, res in pool.poll(timeout=0.5):
            if tid == task_id:
                return res
    raise TimeoutError(f"task {task_id} never completed")


def test_quarantine_propagates_through_the_shared_cache(tmp_path):
    """Every batched launch in worker 0 fails: its ladder isolates and
    quarantines the combo in the shared file; worker 1 then plans around
    it on its first attempt, never running the poisoned combo."""
    m = random_sparse(48, 48, 0.05, seed=1)
    payload = {"bucket": svc.bucket_key(m, m),
               "pairs": [(coord.pack_csr(m), coord.pack_csr(m))] * 2,
               "engine": "auto", "max_batch": 4,
               "policy": {"max_attempts": 2, "backoff_base_s": 0.0}}
    specs = {0: [fi.FaultSpec(site="kernel.batched", kind="raise")]}
    with deadline(), _pool(tmp_path, fault_specs=specs) as pool:
        res1 = _wait(pool, pool.submit(dict(payload), prefer=0))
        assert all(o["ok"] for o in res1["outcomes"])
        assert res1["flush"]["tier"] == "isolated"
        shared = dp.AutotuneCache(pool.cache_path)
        poisoned = {e for e, _ in shared.quarantined(dp.cache_key(m, m))}
        assert poisoned
        res2 = _wait(pool, pool.submit(dict(payload), prefer=1))
    f2 = res2["flush"]
    assert all(o["ok"] for o in res2["outcomes"])
    assert f2["tier"] == "planned" and f2["attempts"] == 1
    assert not f2["errors"] and f2["engine"] not in poisoned


def test_lost_pool_falls_back_to_the_local_ladder(tmp_path, traffic,
                                                  inline_run):
    specs = [fi.FaultSpec(site="service.flush", kind="kill_process",
                          max_fires=1)]
    with deadline(), _pool(tmp_path, n=1, fault_specs=specs,
                           max_worker_restarts=0) as pool:
        service = _service(pool.cache_path, coordinator=pool)
        reqs = _serve(service, traffic[:8])
        assert pool.alive_count == 0
    assert all(r.done for r in reqs) and not service.dead_letters
    assert service.stats()["availability"] == 1.0
    for r in reqs:  # this process's planned tier: the same bits
        assert r.tier == "planned" and _equal(r.result,
                                              inline_run[r.id].result)


def _owned_by(worker, n_workers=2, n=48):
    """A request whose pad bucket's rendezvous owner is ``worker``."""
    for seed in range(100):
        A = random_sparse(n, n, 0.02, seed=seed)
        key = repr(svc.bucket_key(A, A))
        if max(range(n_workers), key=lambda w: coord._hrw(key, w)) == worker:
            return A
    raise AssertionError(f"no bucket owned by worker {worker}")


def test_worker_killed_mid_warm_costs_no_request(tmp_path):
    """Worker 0 SIGKILLed inside the warm of a bucket it owns: the warm
    re-runs on worker 1, worker 0 is respawned, and the bucket's traffic
    is served through the pool — availability 1.0."""
    kill = fi.FaultSpec(site="service.warm", kind="kill_process",
                        max_fires=1)
    A = _owned_by(0)
    with deadline(), _pool(tmp_path, fault_specs={0: [kill]},
                           max_task_retries=1) as pool:
        warmer = PlanWarmer(configured=[(A, A)], neighbors=False)
        service = _service(pool.cache_path, coordinator=pool, warmer=warmer)
        assert service.prewarm(timeout=60.0) == 1
        events = [e["event"] for e in pool.events]
        assert events == ["spawn", "spawn", "worker_lost", "spawn",
                          "restart", "remesh"]
        assert pool.events[2]["worker"] == 0 and pool.events[2]["orphans"]
        assert service.warm_log[-1]["ok"] and warmer.is_warmed(
            svc.bucket_key(A, A))
        reqs = _serve(service, [(A, A)] * 4)
    assert all(r.done for r in reqs) and not service.dead_letters
    assert service.stats()["availability"] == 1.0
    assert [f.tier for f in service.flush_log] == ["planned"]
    for r in reqs:
        want = dp.spgemm(r.A, r.B, engine=r.engine, device="cpu")
        assert _equal(r.result, want)


def test_kernel_error_in_a_worker_raises_out_of_drain(tmp_path, traffic):
    """Rule (a) across the process boundary: a ``KernelLaunchError`` at
    the batched kernel launch in a worker raises out of the parent's
    ``drain`` naming the worker; the task is answered once, never
    re-queued on the survivor or served by this process's ladder; the
    worker is reaped and respawned."""
    fault = fi.FaultSpec(site="kernel.batched",
                         exc_factory=_build.KernelLaunchError)
    A, B = traffic[0]
    with deadline(), _pool(tmp_path, fault_specs=[fault]) as pool:
        service = _service(pool.cache_path, coordinator=pool)
        reqs = [service.submit(A, B) for _ in range(3)]
        with pytest.raises(_build.KernelLaunchError,
                           match=r"^worker \d: KernelLaunchError: "):
            service.drain(timeout=60.0)
        events = list(pool.events)
        assert pool.in_flight == 0 and pool._next_task == 1
        assert pool.alive_count == 2
    assert not any(r.done for r in reqs)
    assert not service.flush_log and not service.dead_letters
    assert service.pending == 0
    names = [e["event"] for e in events]
    assert names == ["spawn", "spawn", "task_error", "worker_lost", "spawn",
                     "restart", "remesh"]
    err, lost = events[2], events[3]
    assert err["kind"] == "KernelLaunchError" and err["task"] == 0
    assert lost == {"event": "worker_lost", "worker": err["worker"],
                    "why": "kernel error (KernelLaunchError)",
                    "orphans": []}
