"""Continuous SpGEMM serving: admission -> bucketed lanes -> plan.

Port of ``repro.serving.spgemm_service``.  The dispatch layer's caches
only pay off under a *stream* of requests.  Callers ``submit`` CSR pairs
of mixed shapes and densities; requests are queued per **pad bucket**
(operand shapes + power-of-two nnz bounds), so every flush of a bucket
builds ``BatchedCSR`` lanes with identical tensor shapes and lands on
one plan; a bucket flushes when it reaches ``max_batch`` lanes or its
oldest request ages past ``flush_timeout``.  Execution goes through the
work-balanced sharded plan path (``distributed/spgemm_shard.py``) on the
service's devices (every card unless the caller names others; the first
is the service's device, where requests' operands and results live), and
every flush records its plan provenance — after warm-up, selections come
from the autotune cache (or a confident dispatch model) and the plan hit
rate approaches 1.

**Async flushes**: with ``async_flushes > 0`` a full or timed-out bucket
is handed to a flush executor thread and ``submit`` returns at once;
``pump``/``drain`` land finished outcomes.  The supervised ladder
(``_run_ladder``) touches no shared service state; all accounting happens
at collection time on the admission side (``_land``).  ``submit``,
``pump`` and ``drain`` are thread-safe.  **One stream**: a flush thread
launches on its device's default stream, the caller's stream, and sets
no other; so a result made on a flush thread and read on the caller's
thread is ordered without events or ``record_stream``, and the caching
allocator cannot hand its memory to the next flush early.

**Worker processes**: with a ``coordinator`` (a :class:`~repro_torch.
runtime.coordinator.ProcessCoordinator`) a flush is packed (host numpy)
and dispatched to a worker process, whose local service runs the ladder
on its lane devices; ``pump``/``drain`` collect finished tasks and
unpack each result onto this service's device.

**Warming ahead of traffic**: a :class:`~repro_torch.serving.plan_warmer.
PlanWarmer` predicts upcoming pad buckets and the service warms them
through ``{"kind": "warm"}`` pool tasks (landing on the worker that will
flush the bucket), on the flush executor, or inline from ``prewarm``,
through :func:`repro_torch.core.dispatch.warm_bucket`.  Each flush
records whether its plan was warmed (``FlushRecord.warm_hit``); warmed
esc capacities seed the bucket's sticky cap so real flushes pin to the
warmed plan identity.

**Failure model**: operands are validated at ``submit``
(:class:`~repro_torch.core.formats.InvalidOperand` names the bad field);
each flush retries the planned tier with backoff, then walks the
degradation ladder of the service's device (``dispatch.degrade_chain``:
on a card ``spz-fused/cuda`` then ``esc``; on the CPU the reference's
chain), quarantining the poisoned (engine, backend, bucket) combo, and
finally *isolates* each request alone (:func:`isolation_engine`: ``esc``
on a card, the reference's ``scl-array`` on the CPU), so one poisoned
request dead-letters alone.  A lost shard worker is recovered one layer
down (``_execute_groups``).  Injected faults, ``CorruptOutput`` and
``WorkerLost`` walk the ladder.  Every request resolves: ``result`` on
success, or a :class:`SpgemmError` on the dead-letter queue.
Per-request deadlines (``policy.deadline_s``, on the service clock from
submission) bound how long a request may be retried.

Two rules keep a failed kernel visible, in process and across the
process boundary:

  (a) **A kernel error reaches the caller.**  A kernel that fails to
      build or launch, or a fault the card reports (``kb.KERNEL_ERRORS``),
      is never retried, degraded or dead-lettered: it raises out of
      ``submit`` (inline flush), ``pump``/``drain`` (the one that
      collects an async flush or a pool task) or ``prewarm``.  From a
      worker process it comes back marked as a kernel error and is
      raised here as ``KernelBuildError``/``KernelLaunchError`` naming
      the worker and its message; it is never re-queued on a survivor
      nor sent down this process's ladder.  The worker exits and the
      coordinator respawns it within budget.
  (b) **Worker loss follows the reference.**  A SIGKILLed or hung worker
      is not the program's kernels failing: its flush re-runs on a
      survivor, and when the pool is lost (or ``drain`` times out) the
      flush runs through this process's ladder — on a card the card's
      own (``spz-fused/cuda``, then ``esc``, isolation on ``esc``), never
      the host or the plain tier.

The clock is injectable (and ``submit``/``pump`` take an explicit
``now``) so tests drive deterministic virtual traffic; the CLI
(``launch/serve_spgemm.py``) uses the wall clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent import futures as cf
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import dispatch as dp
from repro_torch.core.formats import CSR, batch_csr, validate_operands
from repro_torch.distributed import spgemm_shard as shard
from repro_torch.kernels import _build
from repro_torch.kernels import backend as kb
from repro_torch.runtime import coordinator as coord
from repro_torch.runtime import faultinject as fi


def _pow2_bucket(n: int) -> int:
    """Power-of-two pad bound >= n (min 16): the nnz capacity every
    request in a bucket is padded to, so one plan serves the bucket."""
    return 1 << max(4, int(max(int(n), 1) - 1).bit_length())


def bucket_key(A: CSR, B: CSR) -> tuple:
    """(A.shape, B.shape, pad bucket of A.nnz, pad bucket of B.nnz)."""
    return (A.shape, B.shape, _pow2_bucket(int(A.indptr[-1])),
            _pow2_bucket(int(B.indptr[-1])))


def isolation_engine(device) -> str:
    """The engine that serves a request alone at the ladder's last tier:
    on a card ``esc``, the card chain's last tier, so isolation never
    leaves the card; elsewhere the reference's ``scl-array``."""
    return "esc" if torch.device(device).type == "cuda" else "scl-array"


@dataclasses.dataclass
class SpgemmError:
    """Structured failure result for one request (the dead-letter
    payload): where it failed, why, and after how many attempts."""

    id: int
    bucket: tuple
    stage: str        # "flush" | "isolate" | "deadline"
    kind: str         # exception class name ("DeadlineExceeded", ...)
    message: str
    attempts: int
    t: float

    def __str__(self) -> str:
        return (f"SpgemmError(request {self.id} @ {self.stage}: "
                f"{self.kind}: {self.message})")


@dataclasses.dataclass
class SpGemmRequest:
    """One queued multiply; exactly one of ``result`` / ``error`` lands
    when its bucket flushes (or its deadline expires)."""

    A: CSR
    B: CSR
    id: int
    t_submit: float
    bucket: tuple
    result: Optional[CSR] = None
    error: Optional[SpgemmError] = None
    t_done: Optional[float] = None
    engine: Optional[str] = None
    tier: Optional[str] = None   # "planned" | "degraded:..." | "isolated"

    @property
    def done(self) -> bool:
        return self.result is not None or self.error is not None

    @property
    def failed(self) -> bool:
        return self.error is not None

    @property
    def latency(self) -> float:
        if self.t_done is None:
            raise ValueError(f"request {self.id} not finished")
        return self.t_done - self.t_submit


@dataclasses.dataclass
class FlushRecord:
    """Per-flush provenance: which bucket ran, on what plan, why, and —
    under failure — which tier actually served and at what cost."""

    bucket: tuple
    n_requests: int
    engine: str
    source: str        # plan selection source ("cache", "heuristic", ...)
    reason: str        # "full" | "timeout" | "drain"
    t: float
    wall_s: float      # host wall-clock spent executing the flush
    tier: str = "planned"   # "planned" | "degraded:<engine>" | "isolated"
    attempts: int = 1       # execution attempts across tiers
    n_failed: int = 0       # requests dead-lettered by this flush
    errors: tuple = ()      # per-attempt error trail (str)
    warm_hit: bool = False  # planned tier landed on a warmed plan
    # a pool flush: the worker's kernel launch counts for this flush
    launches: dict = dataclasses.field(default_factory=dict)

    @property
    def plan_hit(self) -> bool:
        # selection that skipped measurement and the heuristic table:
        # a replayed cache entry or a confident model prediction
        return self.source in ("cache", "model")

    @property
    def degraded(self) -> bool:
        return self.tier != "planned"


@dataclasses.dataclass
class _FlushOutcome:
    """What one supervised ladder run produced, detached from service
    state: per-request results/dead-letters keyed by position in the
    flushed batch, plus the flush's provenance.  Built by
    ``_run_ladder`` (possibly on an executor thread), applied by
    ``_land`` (always on the admission side, under the service lock)."""

    results: dict      # index -> (CSR result, engine, tier)
    dead: dict         # index -> (stage, kind, message, attempts)
    engine: str
    source: str
    tier: str
    attempts: int
    errors: tuple
    warm_hit: bool = False


class SpGemmService:
    """Batched continuous serving over the plan/execute dispatch stack.

    max_batch:     lanes per flush (also the BatchedCSR batch_cap, so
                   every flush of a bucket has the same shapes).
    flush_timeout: seconds a bucket may age before ``pump`` flushes it
                   partially filled.
    engine/rules/cache: forwarded to planning (``plan_sharded``).
    devices:       devices for sharded execution (``shard.lane_devices``:
                   every card by default, or what the caller names, e.g.
                   ``"cpu"``); the first is the service's device.
    clock:         time source for submit/done stamps (injectable).
    policy:        :class:`~repro_torch.core.dispatch.RetryPolicy`
                   governing per-flush retries, backoff, the ladder
                   (``fallback=None``: the device's ``degrade_chain``),
                   and the per-request deadline (``deadline_s``, taken
                   against this service's clock).
    async_flushes: > 0 runs flushes on a thread pool of that size
                   instead of inline; ``pump``/``drain`` land finished
                   outcomes.  0 (the default) keeps the inline flush.
    warmer:        a :class:`~repro_torch.serving.plan_warmer.PlanWarmer`;
                   when set, ``submit`` feeds it the admission stream,
                   ``pump`` dispatches warm work for the buckets it
                   predicts (with an executor or a pool), and
                   ``prewarm()`` warms configured traffic classes before
                   the first request.
    coordinator:   a :class:`~repro_torch.runtime.coordinator.
                   ProcessCoordinator` — when set, flushes are
                   *dispatched* to its worker processes instead of run
                   here: ``_flush`` submits a packed task and returns,
                   ``pump``/``drain`` collect finished tasks.  A worker
                   lost mid-flush is recovered by the coordinator (re-run
                   on a survivor); when the whole pool is lost, the
                   affected requests run through this process's ladder.
                   A kernel error in a worker raises here (rule (a)).
    bucket_caps:   optional shared sticky-cap dict (bucket -> esc
                   cap_products); pool workers pass a per-process dict
                   so caps — and the warmed plan identities they pin —
                   survive across their per-task service instances."""

    def __init__(self, *, max_batch: int = 8, flush_timeout: float = 0.02,
                 engine: str = "auto",
                 devices=None,
                 cache: Optional[dp.AutotuneCache] = None,
                 rules=dp.DEFAULT_HEURISTICS,
                 clock: Callable[[], float] = time.monotonic,
                 policy: Optional[dp.RetryPolicy] = None,
                 async_flushes: int = 0,
                 warmer=None,
                 coordinator=None,
                 bucket_caps: Optional[dict] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.flush_timeout = flush_timeout
        self.engine = engine
        self.devices = shard.lane_devices(devices)
        self.device = self.devices[0]
        self.cache = cache if cache is not None else dp.default_cache()
        self.rules = rules
        self.clock = clock
        self.policy = policy if policy is not None else dp.RetryPolicy()
        self.coordinator = coordinator
        self.warmer = warmer
        self.async_flushes = int(async_flushes)
        self._executor = (cf.ThreadPoolExecutor(
            max_workers=self.async_flushes,
            thread_name_prefix="spgemm-flush")
            if self.async_flushes > 0 else None)
        # admission/bookkeeping lock: submit/pump/drain are thread-safe
        # (concurrent client threads); ladder threads never take it
        self._mu = threading.RLock()
        self._caps_mu = threading.Lock()
        self._queues: dict[tuple, list[SpGemmRequest]] = {}
        self._opened: dict[tuple, float] = {}
        # sticky esc caps per bucket; injectable so a pool worker keeps
        # its caps across the per-task service instances it builds
        self._bucket_caps: dict[tuple, int] = \
            bucket_caps if bucket_caps is not None else {}
        self._next_id = 0
        self._by_id: dict[int, SpGemmRequest] = {}
        # pool task id -> (bucket, requests, reason, t_flush, t0)
        self._inflight: dict[int, tuple] = {}
        # local future id -> (bucket, requests, reason, t_flush, t0, fut)
        self._local_inflight: dict[int, tuple] = {}
        self._next_local = 0
        # warm work in flight: pool task id -> (bucket, t0) / local id ->
        # (bucket, fut, t0)
        self._warm_inflight: dict[int, tuple] = {}
        self._local_warm: dict[int, tuple] = {}
        self._next_warm = 0
        self.completed: list[SpGemmRequest] = []
        self.dead_letters: list[SpGemmRequest] = []
        self.flush_log: list[FlushRecord] = []
        self.warm_log: list[dict] = []

    # -- intake ----------------------------------------------------------

    def submit(self, A: CSR, B: CSR,
               now: Optional[float] = None) -> SpGemmRequest:
        """Queue one multiply on the service's device; flushes its bucket
        if that fills it.

        Malformed operands are rejected *here* with a structured
        :class:`~repro_torch.core.formats.InvalidOperand` naming the
        field — they never reach a kernel, and never poison a
        co-bucketed batch."""
        validate_operands(A, B)
        key = bucket_key(A, B)
        A, B = A.to(self.device), B.to(self.device)
        with self._mu:
            now = self.clock() if now is None else now
            req = SpGemmRequest(A=A, B=B, id=self._next_id, t_submit=now,
                                bucket=key)
            self._next_id += 1
            self._by_id[req.id] = req
            if self.warmer is not None:
                self.warmer.observe(key, A, B)
            q = self._queues.setdefault(key, [])
            if not q:
                self._opened[key] = now
            q.append(req)
            if len(q) >= self.max_batch:
                self._flush(key, now, reason="full")
            return req

    def lookup(self, request_id: int) -> SpGemmRequest:
        """The request for an id — every submitted id resolves here,
        whether it completed, dead-lettered, or is still pending."""
        return self._by_id[request_id]

    @property
    def pending(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + sum(len(e[1]) for e in self._inflight.values())
                + sum(len(e[1]) for e in self._local_inflight.values()))

    # -- flushing --------------------------------------------------------

    def pump(self, now: Optional[float] = None) -> int:
        """Flush every bucket whose oldest request aged past the
        timeout; returns the number of requests completed.

        This is also the collection point for every asynchronous
        completion — pool tasks and executor flushes land here — and the
        warmer's heartbeat: buckets the warmer predicts get their warm
        work dispatched."""
        with self._mu:
            now = self.clock() if now is None else now
            done = self._collect(block=False)
            done += self._collect_local()
            self._collect_warm_local()
            for key in [k for k, t in self._opened.items()
                        if now - t >= self.flush_timeout]:
                done += self._flush(key, now, reason="timeout")
            self._pump_warmer()
            return done

    def drain(self, now: Optional[float] = None,
              timeout: float = 300.0) -> int:
        """Flush everything regardless of age (shutdown / end of a run).

        Blocks until every dispatched pool task and in-flight async
        flush came back (or ``timeout`` expired — pool stragglers then
        run through this process's ladder and executor stragglers
        dead-letter, so drain still resolves every request)."""
        with self._mu:
            now = self.clock() if now is None else now
            done = 0
            for key in list(self._queues):
                done += self._flush(key, now, reason="drain")
            if self._inflight or self._warm_inflight:
                done += self._collect(block=True, timeout=timeout)
                for tid in list(self._inflight):
                    # the pool never answered: serve the stragglers here
                    done += self._finish_remote(
                        tid, {"pool_lost": True, "why": "drain timeout"})
            done += self._wait_local(timeout)
            return done

    def close(self, wait: bool = True) -> None:
        """Shut down the flush executor (no-op without async flushes)."""
        if self._executor is not None:
            self._executor.shutdown(wait=wait, cancel_futures=not wait)

    def _stick_bucket_cap(self, key: tuple, sp):
        """Pin a bucket's esc product capacity to its running maximum.

        plan_batched sizes cap_products from the flush's actual lane
        works, which can cross a power-of-two boundary between flushes
        of the same pad bucket.  Raising the cap to the bucket's
        historical max is always safe (it is an upper bound) and makes
        the plan identity stable once the bucket has seen its heaviest
        traffic.  Warming seeds the same map, so a warmed bucket's first
        real flush already pins to the warmed capacity."""
        if sp.base.engine != "esc":
            return sp
        cap = sp.base.kwargs_dict.get("cap_products")
        with self._caps_mu:
            sticky = max(cap, self._bucket_caps.get(key, 0))
            self._bucket_caps[key] = sticky
        if sticky == cap:
            return sp
        kwargs = tuple(sorted({**sp.base.kwargs_dict,
                               "cap_products": sticky}.items()))
        return dataclasses.replace(
            sp, base=dataclasses.replace(sp.base, kwargs=kwargs))

    # -- failure handling ------------------------------------------------

    def _dead_letter(self, r: SpGemmRequest, stage: str, kind: str,
                     message: str, attempts: int) -> None:
        r.error = SpgemmError(id=r.id, bucket=r.bucket, stage=stage,
                              kind=kind, message=message, attempts=attempts,
                              t=self.clock())
        r.t_done = self.clock()
        self.dead_letters.append(r)

    @staticmethod
    def _check_outputs(out, reqs: list) -> None:
        """Screen every lane of a flush result; silent garbage (injected
        NaNs, out-of-range indices) counts as a failed attempt."""
        for i in range(len(reqs)):
            dp.check_result(out[i])

    def _run_batched(self, reqs: list, key: tuple, planner) -> object:
        """Build the padded batch for ``reqs`` and run one execution
        attempt through ``planner(A, B)``."""
        _, _, cap_a, cap_b = key
        A = batch_csr([r.A for r in reqs], nnz_cap=cap_a,
                      batch_cap=self.max_batch)
        B = batch_csr([r.B for r in reqs], nnz_cap=cap_b,
                      batch_cap=self.max_batch)
        return planner(A, B)

    def _flush(self, key: tuple, now: float, reason: str) -> int:
        """Flush one bucket: to the worker pool when a coordinator is
        attached, to the flush executor under ``async_flushes``, inline
        otherwise."""
        if self.coordinator is not None:
            return self._flush_remote(key, now, reason)
        if self._executor is not None:
            return self._flush_async(key, now, reason)
        return self._flush_local(key, now, reason)

    # -- multi-process flushing -----------------------------------------

    def _flush_remote(self, key: tuple, now: float, reason: str) -> int:
        """Pack the bucket into a task and hand it to the worker pool.

        Returns 0 — completion is asynchronous; ``pump``/``drain``
        collect.  A pool that is already fully lost degrades to this
        process's ladder right here."""
        reqs = self._queues.pop(key, [])
        self._opened.pop(key, None)
        if not reqs:
            return 0
        payload = coord.make_flush_payload(
            reqs, bucket=key, engine=self.engine, max_batch=self.max_batch,
            policy=self.policy)
        with self._caps_mu:
            sticky = self._bucket_caps.get(key)
        if sticky:
            payload["sticky_cap"] = sticky
        try:
            tid = self.coordinator.submit(payload)
        except coord.PoolLost:
            self._queues[key] = reqs
            return self._flush_local(key, now, reason)
        self._inflight[tid] = (key, reqs, reason, now, time.perf_counter())
        return 0

    def _collect(self, block: bool, timeout: float = 300.0) -> int:
        """Absorb finished pool tasks into request completions."""
        if self.coordinator is None or \
                not (self._inflight or self._warm_inflight):
            return 0
        done = 0
        deadline = time.monotonic() + timeout
        while True:
            results = self.coordinator.poll(timeout=0.2 if block else 0.0)
            done += self._land_remote(results)
            if not block or not self._inflight:
                break
            if not results and time.monotonic() >= deadline:
                break
        return done

    def _land_remote(self, results: list) -> int:
        """Land a poll's results (flushes and warms); a kernel error among
        them raises after the others have landed."""
        done, fault = 0, None
        for tid, res in results:
            try:
                if tid in self._warm_inflight:
                    self._finish_warm_remote(tid, res)
                else:
                    done += self._finish_remote(tid, res)
            except kb.KERNEL_ERRORS as e:
                fault = fault or e
        if fault is not None:
            raise fault
        return done

    @staticmethod
    def _check_remote_kernel_error(res: dict) -> None:
        """Rule (a) across the process boundary: a worker's kernel error
        raises here, naming the worker."""
        err = res.get("error") if isinstance(res, dict) else None
        if not err or not err.get("kernel"):
            return
        cls = _build.KernelBuildError if err.get("kind") == \
            "KernelBuildError" else _build.KernelLaunchError
        raise cls(f"worker {err.get('worker')}: {err.get('kind')}: "
                  f"{err.get('message')}")

    def _finish_remote(self, tid: int, res: dict) -> int:
        """Land one pool task's outcome on its requests.

        Success lands per-request results (unpacked onto this service's
        device) and dead letters plus the worker's flush provenance; a
        kernel error raises (rule (a)); ``pool_lost`` or another error
        re-queues the bucket through this process's ladder (rule (b)),
        so every request still resolves."""
        inflight = self._inflight.pop(tid, None)
        if inflight is None:
            return 0
        key, reqs, reason, t_flush, t0 = inflight
        self._check_remote_kernel_error(res)
        if "outcomes" not in res:
            # the pool could not run it (lost / infrastructural error):
            # degrade to this process's ladder
            self._queues.setdefault(key, []).extend(reqs)
            return self._flush_local(key, t_flush, reason)
        t_done = self.clock()
        done_n = 0
        for r, o in zip(reqs, res["outcomes"]):
            if o["ok"]:
                r.result = coord.unpack_csr(o["result"], self.device)
                r.t_done = t_done
                r.engine = o.get("engine")
                r.tier = o.get("tier")
                self.completed.append(r)
                done_n += 1
            else:
                self._dead_letter(r, o.get("stage", "flush"),
                                  o.get("kind", "Error"),
                                  o.get("message", ""),
                                  o.get("attempts", 1))
        f = res.get("flush") or {}
        self.flush_log.append(FlushRecord(
            bucket=key, n_requests=len(reqs),
            engine=f.get("engine", "?"), source=f.get("source", "?"),
            reason=reason, t=t_flush,
            wall_s=time.perf_counter() - t0,
            tier=f.get("tier", "planned"),
            attempts=f.get("attempts", 1),
            n_failed=len(reqs) - done_n,
            errors=tuple(f.get("errors", ())),
            warm_hit=bool(f.get("warm_hit", False)),
            launches=dict(f.get("launches") or {})))
        return done_n

    # -- async local flushing -------------------------------------------

    def _flush_async(self, key: tuple, now: float, reason: str) -> int:
        """Hand one bucket's ladder to the flush executor and return —
        admission never waits on execution.  ``pump``/``drain`` land
        the outcome."""
        reqs = self._queues.pop(key, [])
        self._opened.pop(key, None)
        if not reqs:
            return 0
        tid = self._next_local
        self._next_local += 1
        fut = self._executor.submit(self._run_ladder, key, list(reqs),
                                    reason)
        self._local_inflight[tid] = (key, reqs, reason, now,
                                     time.perf_counter(), fut)
        return 0

    def _collect_local(self, wait_s: float = 0.0) -> int:
        """Land every finished executor flush; optionally wait up to
        ``wait_s`` for one to finish first.  A kernel error raised on a
        flush thread is raised here, on the collecting caller."""
        if not self._local_inflight:
            return 0
        if wait_s > 0.0:
            cf.wait([e[5] for e in self._local_inflight.values()],
                    timeout=wait_s, return_when=cf.FIRST_COMPLETED)
        done = 0
        ready = [tid for tid, e in list(self._local_inflight.items())
                 if e[5].done()]
        for tid in ready:
            key, reqs, reason, t_flush, t0, fut = \
                self._local_inflight.pop(tid)
            try:
                outcome = fut.result()
            except kb.KERNEL_ERRORS:
                raise
            except Exception as e:  # ladder itself crashed (injected/bug)
                outcome = _FlushOutcome(
                    results={}, dead={}, engine="?", source="failed",
                    tier="failed", attempts=1,
                    errors=(f"{type(e).__name__}: {e}",))
            done += self._land(key, reqs, reason, t_flush, t0, outcome)
        return done

    def _wait_local(self, timeout: float) -> int:
        """Drain-time barrier for executor flushes: wait, land, and
        dead-letter anything still running past the deadline (a hung
        ladder must not leave ids unresolved)."""
        done = 0
        deadline = time.monotonic() + timeout
        while self._local_inflight and time.monotonic() < deadline:
            done += self._collect_local(
                wait_s=min(0.1, max(deadline - time.monotonic(), 0.0)))
        for tid in list(self._local_inflight):
            key, reqs, reason, t_flush, t0, fut = \
                self._local_inflight.pop(tid)
            outcome = _FlushOutcome(
                results={}, dead={}, engine="?", source="failed",
                tier="abandoned", attempts=1,
                errors=("drain timeout: flush still in executor",))
            done += self._land(key, reqs, reason, t_flush, t0, outcome)
        return done

    # -- the supervised ladder ------------------------------------------

    def _run_ladder(self, key: tuple, reqs: list,
                    reason: str) -> _FlushOutcome:
        """One bucket's supervised execution: planned tier with bounded
        retries, then the degradation ladder, then per-request
        isolation.  Reads service config but mutates no shared
        bookkeeping (sticky caps are the one lock-guarded exception), so
        concurrent ladders cannot interleave each other's state; ``_land``
        applies the returned outcome under the service lock.  Kernel
        errors (``kb.KERNEL_ERRORS``) raise from any tier."""
        fi.fire("service.flush", bucket=key, reason=reason)
        results: dict[int, tuple] = {}
        dead: dict[int, tuple] = {}
        pending = list(enumerate(reqs))
        attempts = 0
        errors: list[str] = []
        out = None
        sp = None
        engine, source, tier = "?", "failed", "planned"
        warm_hit = False

        def expire(pend):
            """Move deadline-passed requests to ``dead``; keep the rest."""
            if self.policy.deadline_s is None:
                return pend
            now = self.clock()
            keep = []
            for i, r in pend:
                if now - r.t_submit >= self.policy.deadline_s:
                    dead[i] = ("deadline", "DeadlineExceeded",
                               f"age {now - r.t_submit:.3f}s >= deadline "
                               f"{self.policy.deadline_s}s", attempts)
                else:
                    keep.append((i, r))
            return keep

        # -- tier 0: the planned sharded flush, with bounded retries ----
        for attempt in range(1, self.policy.max_attempts + 1):
            pending = expire(pending)
            if not pending:
                break
            attempts += 1
            try:
                def planned(A, B):
                    nonlocal sp
                    sp = shard.plan_sharded(A, B, self.engine,
                                            devices=self.devices,
                                            cache=self.cache,
                                            rules=self.rules)
                    sp = self._stick_bucket_cap(key, sp)
                    return shard.execute_sharded(sp, A, B)
                out = self._run_batched([r for _, r in pending], key,
                                        planned)
                self._check_outputs(out, pending)
                engine, source, tier = sp.base.engine, sp.base.source, \
                    "planned"
                warm_hit = dp.jit_warmed(sp.base.jit_key)
                break
            except kb.KERNEL_ERRORS:
                raise
            except Exception as e:
                errors.append(f"planned#{attempt}: {type(e).__name__}: {e}")
                out = None
                if attempt < self.policy.max_attempts:
                    self.policy.sleep(self.policy.backoff_s(attempt))

        # -- tier 1..n: the device's degradation ladder -----------------
        if out is None and pending:
            if sp is not None:
                # the planned combo kept crashing this bucket: poison it
                # so the next plan does not re-select the same kernel
                self.cache.quarantine(sp.base.cache_key, sp.base.engine,
                                      sp.base.backend,
                                      reason=errors[-1] if errors else "")
            planned_combo = (sp.base.engine, sp.base.backend) \
                if sp is not None else (None, None)
            fallback = self.policy.fallback
            if fallback is None:
                fallback = dp.degrade_chain(self.device)
            for eng, bk in fallback:
                if (eng, bk) == planned_combo:
                    continue
                spec = dp.available_engines().get(eng)
                if spec is None or not spec.batchable:
                    continue  # non-batchable tiers are the isolation path
                pending = expire(pending)
                if not pending:
                    break
                attempts += 1
                try:
                    def degraded(A, B, eng=eng, bk=bk):
                        bp = dp.plan_batched(A, B, engine=eng,
                                             backend=bk or "auto",
                                             device=self.device,
                                             cache=self.cache)
                        return dp.execute_batched(bp, A, B)
                    out = self._run_batched([r for _, r in pending], key,
                                            degraded)
                    self._check_outputs(out, pending)
                    engine, source = eng, "fallback"
                    tier = f"degraded:{eng}" + (f"/{bk}" if bk else "")
                    break
                except kb.KERNEL_ERRORS:
                    raise
                except Exception as e:
                    errors.append(f"{eng}/{bk or '-'}: "
                                  f"{type(e).__name__}: {e}")
                    out = None

        if out is not None and pending:
            for j, (i, _) in enumerate(pending):
                results[i] = (out[j], engine, tier)
        elif pending:
            # -- final tier: each request alone, on the device — one
            # poisoned request must not sink its batch ------------------
            engine = isolation_engine(self.device)
            tier, source = "isolated", "isolated"
            for i, r in pending:
                if not expire([(i, r)]):
                    continue
                attempts += 1
                try:
                    res = dp.spgemm(r.A, r.B, engine=engine,
                                    device=self.device, cache=self.cache)
                    dp.check_result(res)
                    results[i] = (res, engine, tier)
                except kb.KERNEL_ERRORS:
                    raise
                except Exception as e:
                    errors.append(f"isolate#{r.id}: {type(e).__name__}: {e}")
                    dead[i] = ("isolate", type(e).__name__, str(e), attempts)

        return _FlushOutcome(results=results, dead=dead, engine=engine,
                             source=source, tier=tier,
                             attempts=max(attempts, 1),
                             errors=tuple(errors), warm_hit=warm_hit)

    def _land(self, key: tuple, reqs: list, reason: str, t_flush: float,
              t0: float, outcome: _FlushOutcome) -> int:
        """Apply one ladder outcome to service bookkeeping (admission
        side, under the service lock): stamp results, dead-letter
        failures, append the flush record."""
        t_done = self.clock()
        done_n = 0
        for i, r in enumerate(reqs):
            res = outcome.results.get(i)
            if res is not None:
                r.result, r.engine, r.tier = res
                r.t_done = t_done
                self.completed.append(r)
                done_n += 1
                continue
            d = outcome.dead.get(i)
            if d is None:
                d = ("flush", "Unresolved",
                     "; ".join(outcome.errors) or "no outcome recorded",
                     outcome.attempts)
            self._dead_letter(r, *d)
        self.flush_log.append(FlushRecord(
            bucket=key, n_requests=len(reqs), engine=outcome.engine,
            source=outcome.source, reason=reason, t=t_flush,
            wall_s=time.perf_counter() - t0, tier=outcome.tier,
            attempts=outcome.attempts, n_failed=len(reqs) - done_n,
            errors=outcome.errors, warm_hit=outcome.warm_hit))
        return done_n

    # -- in-process flushing --------------------------------------------

    def _flush_local(self, key: tuple, now: float, reason: str) -> int:
        """Synchronous flush: run the ladder inline and land it."""
        reqs = self._queues.pop(key, [])
        self._opened.pop(key, None)
        if not reqs:
            return 0
        t0 = time.perf_counter()
        outcome = self._run_ladder(key, reqs, reason)
        return self._land(key, reqs, reason, now, t0, outcome)

    # -- warming ahead of traffic ---------------------------------------

    def prewarm(self, buckets=None, block: bool = True,
                timeout: float = 300.0) -> int:
        """Warm pad buckets ahead of traffic.

        ``buckets`` defaults to everything the warmer currently
        predicts (configured traffic classes first).  Warm work runs on
        the worker pool or the flush executor when there is one, inline
        otherwise; with ``block`` the call returns only after the
        dispatched warms finished.  Returns the number of buckets
        dispatched."""
        with self._mu:
            if buckets is None:
                buckets = self.warmer.due() if self.warmer is not None \
                    else []
            n = 0
            for b in buckets:
                n += int(self._dispatch_warm(tuple(b)))
            if block:
                self._await_warms(timeout)
            return n

    def _pump_warmer(self) -> None:
        """Dispatch warm work for freshly predicted buckets — only with
        a pool or a flush executor (warming inline from ``pump`` would
        block admission, the very thing warming is for)."""
        if self.warmer is None:
            return
        if self.coordinator is None and self._executor is None:
            return
        for bucket in self.warmer.due():
            self._dispatch_warm(bucket)

    def _dispatch_warm(self, bucket: tuple) -> bool:
        """Route one bucket's warm to the pool / executor / inline."""
        sample = self.warmer.sample(bucket) \
            if self.warmer is not None else None
        with self._caps_mu:
            sticky = self._bucket_caps.get(bucket)
        if self.coordinator is not None:
            payload = {"kind": "warm", "bucket": bucket,
                       "engine": self.engine, "max_batch": self.max_batch,
                       "sticky_cap": sticky}
            if sample is not None:
                payload["pair"] = (coord.pack_csr(sample[0]),
                                   coord.pack_csr(sample[1]))
            try:
                tid = self.coordinator.submit(payload)
            except coord.PoolLost:
                pass  # fall through to a local warm
            else:
                self._warm_inflight[tid] = (bucket, time.perf_counter())
                if self.warmer is not None:
                    self.warmer.mark_pending(bucket)
                return True
        if self._executor is not None:
            fut = self._executor.submit(self._warm_local, bucket, sample,
                                        sticky)
            tid = self._next_warm
            self._next_warm += 1
            self._local_warm[tid] = (bucket, fut, time.perf_counter())
            if self.warmer is not None:
                self.warmer.mark_pending(bucket)
            return True
        # no executor: warm inline (the explicit prewarm path)
        try:
            res = self._warm_local(bucket, sample, sticky)
        except kb.KERNEL_ERRORS:
            raise
        except Exception as e:
            self._note_warm_failed(bucket, f"{type(e).__name__}: {e}")
            return False
        self._note_warm_ok(bucket, res)
        return True

    def _warm_local(self, bucket: tuple, sample, sticky) -> dict:
        return dp.warm_bucket(bucket, engine=self.engine,
                              max_batch=self.max_batch, cache=self.cache,
                              devices=self.devices, rules=self.rules,
                              sample=sample, sticky_cap=sticky)

    def _note_warm_ok(self, bucket: tuple, res: dict) -> None:
        cap = res.get("cap")
        if cap:
            with self._caps_mu:
                self._bucket_caps[bucket] = max(
                    int(cap), self._bucket_caps.get(bucket, 0))
        self.warm_log.append({"ok": True, **res})
        if self.warmer is not None:
            self.warmer.mark_warmed(bucket)

    def _note_warm_failed(self, bucket: tuple, why: str) -> None:
        self.warm_log.append({"ok": False, "bucket": bucket, "error": why})
        if self.warmer is not None:
            self.warmer.mark_failed(bucket, why)

    def _collect_warm_local(self) -> None:
        for tid in [t for t, e in list(self._local_warm.items())
                    if e[1].done()]:
            bucket, fut, _ = self._local_warm.pop(tid)
            try:
                res = fut.result()
            except kb.KERNEL_ERRORS:
                raise
            except Exception as e:
                self._note_warm_failed(bucket, f"{type(e).__name__}: {e}")
            else:
                self._note_warm_ok(bucket, res)

    def _finish_warm_remote(self, tid: int, res: dict) -> None:
        """Land one pool warm: a kernel error raises (rule (a)); a lost
        or failed warm is noted and serving goes on cold."""
        entry = self._warm_inflight.pop(tid, None)
        if entry is None:
            return
        bucket, _ = entry
        self._check_remote_kernel_error(res)
        w = res.get("warm") if isinstance(res, dict) else None
        if w is None:
            err = res.get("error") or {}
            why = err.get("message") or res.get("why") or "warm failed"
            self._note_warm_failed(bucket, str(why))
        else:
            self._note_warm_ok(bucket, w)

    def _await_warms(self, timeout: float) -> None:
        """Block until in-flight warm work resolved (prewarm barrier)."""
        deadline = time.monotonic() + timeout
        while (self._warm_inflight or self._local_warm) \
                and time.monotonic() < deadline:
            self._collect_warm_local()
            if self._warm_inflight and self.coordinator is not None:
                self._land_remote(self.coordinator.poll(timeout=0.1))
            elif self._local_warm:
                cf.wait([e[1] for e in self._local_warm.values()],
                        timeout=0.1, return_when=cf.FIRST_COMPLETED)

    # -- accounting ------------------------------------------------------

    def stats(self, since_request: int = 0, since_flush: int = 0,
              since_dead: int = 0) -> dict:
        """Aggregate serving stats over ``completed[since_request:]`` /
        ``flush_log[since_flush:]`` / ``dead_letters[since_dead:]``
        (snapshot the list lengths at the end of warm-up to get
        steady-state numbers)."""
        done = self.completed[since_request:]
        flushes = self.flush_log[since_flush:]
        dead = self.dead_letters[since_dead:]
        lat = np.asarray([r.latency for r in done], np.float64)
        out = {
            "n_requests": len(done),
            "n_flushes": len(flushes),
            "n_buckets": len({f.bucket for f in flushes}),
            "pending": self.pending,
            "n_dead_letters": len(dead),
            "n_warmed": sum(1 for w in self.warm_log if w.get("ok")),
        }
        resolved = len(done) + len(dead)
        if resolved:
            out["availability"] = len(done) / resolved
        degraded = [r for r in done if r.tier not in (None, "planned")]
        out["n_degraded"] = len(degraded)
        if len(done):
            out["degraded_rate"] = len(degraded) / len(done)
            span = max(r.t_done for r in done) - min(r.t_submit for r in done)
            out["req_per_s"] = len(done) / max(span, 1e-9)
            out["p50_latency_s"] = float(np.percentile(lat, 50))
            out["p95_latency_s"] = float(np.percentile(lat, 95))
            out["p99_latency_s"] = float(np.percentile(lat, 99))
            out["mean_latency_s"] = float(lat.mean())
        if degraded:
            dlat = np.asarray([r.latency for r in degraded], np.float64)
            out["p50_latency_degraded_s"] = float(np.percentile(dlat, 50))
            out["p95_latency_degraded_s"] = float(np.percentile(dlat, 95))
        if flushes:
            # request-weighted: the fraction of traffic served off a
            # cached plan (a rare new pad bucket is one small miss-flush,
            # not 1/Nth of the steady state)
            n_req = sum(f.n_requests for f in flushes)
            out["plan_hit_rate"] = (sum(f.n_requests for f in flushes
                                        if f.plan_hit) / n_req)
            out["flush_hit_rate"] = (sum(f.plan_hit for f in flushes)
                                     / len(flushes))
            # warm hit: the flush landed on a plan warmed ahead of
            # traffic (request-weighted, like plan_hit_rate)
            out["warm_hit_rate"] = (sum(f.n_requests for f in flushes
                                        if f.warm_hit) / n_req)
            out["flush_warm_hit_rate"] = (sum(f.warm_hit for f in flushes)
                                          / len(flushes))
            out["mean_flush_wall_s"] = float(np.mean([f.wall_s
                                                      for f in flushes]))
            out["mean_lanes_per_flush"] = float(np.mean([f.n_requests
                                                         for f in flushes]))
            out["flush_retry_rate"] = (sum(f.attempts > 1 for f in flushes)
                                       / len(flushes))
        return out

    def bucket_outcomes(self) -> dict:
        """Per-bucket autotune outcome: flush count, requests served, the
        engines that ran, and how often selection came from the cache."""
        buckets: dict[tuple, dict] = {}
        for f in self.flush_log:
            b = buckets.setdefault(f.bucket, {
                "flushes": 0, "requests": 0, "plan_hits": 0, "engines": {},
                "degraded": 0, "failed": 0})
            b["flushes"] += 1
            b["requests"] += f.n_requests
            b["plan_hits"] += int(f.plan_hit)
            b["engines"][f.engine] = b["engines"].get(f.engine, 0) + 1
            b["degraded"] += int(f.degraded)
            b["failed"] += f.n_failed
        return buckets
