"""Cross-process worker supervision for multi-process SpGEMM serving.

Port of ``repro.runtime.coordinator``.  A :class:`ProcessCoordinator`
spawns a pool of **worker processes** (multiprocessing, spawn context:
a worker starts CUDA only after the spawn), each owning a slice of the
parent's lane devices (partitioned by :func:`repro_torch.runtime.
elastic.remesh_lanes`; a worker's slice is the first ``n`` of those
devices), and supervises them:

  * **task dispatch** — the serving layer submits *flush tasks* (a pad
    bucket's worth of packed CSR pairs); the coordinator routes each by
    **bucket affinity** (rendezvous hashing over the live workers), so
    repeat flushes of a pad bucket land on the worker that already
    planned it and holds its buffers.  The affinity worker being busy
    queues the task (another worker that has *seen* the bucket may take
    it); only a real backlog (``affinity_spill``) spills it to a cold
    idle worker.  The worker runs each flush through a local
    :class:`~repro_torch.serving.spgemm_service.SpGemmService` on its
    lane devices — the full ladder of the device (retries, the device's
    degradation chain, per-request isolation, dead letters) — and keeps
    its sticky esc caps across tasks, pinning repeat flushes to one plan
    identity.  Each flush record carries the worker's kernel launch
    counts for that flush;
  * **warming ahead of traffic** — ``{"kind": "warm"}`` tasks route
    through the same affinity, so a bucket is warmed
    (:func:`repro_torch.core.dispatch.warm_bucket`) in the very worker
    its flushes will land on;
  * **death detection** — a killed worker is noticed by pipe EOF (plus
    ``exitcode``); its in-flight tasks are re-queued onto survivors
    (preferring a *different* worker), so a SIGKILL mid-flush costs
    latency, never a dropped request;
  * **hang detection** — a worker whose oldest in-flight task ages past
    ``task_timeout_s`` is declared hung, SIGKILLed, and treated as lost;
    idle workers are liveness-checked with ping/pong heartbeats
    (:meth:`heartbeat`) under ``heartbeat_timeout_s``;
  * **bounded restarts** — each lost worker is respawned at most
    ``max_worker_restarts`` times; past the budget the pool shrinks;
  * **elastic re-meshing** — every membership change re-partitions the
    lane space over the live workers and tells each survivor its new
    lane count;
  * **shared state by protocol, not by pipe** — workers share the
    autotune + quarantine cache through its on-disk file (and with it
    the dispatch model trained from it, ``<cache>.model.json``);
  * **total loss is survivable** — when no worker is live and no
    restart budget remains, queued work is handed back marked
    ``pool_lost`` and :meth:`submit` raises :class:`PoolLost`; the
    serving layer's in-process ladder (the card's own, on a card) is
    the fallback.

**Kernel errors are not worker loss.**  A kernel that fails to build or
launch, or a fault the card reports (``kb.KERNEL_ERRORS``), comes back
as an error result that names the worker and is marked ``"kernel"``; the
serving layer raises it to its caller and never re-runs it.  A CUDA
fault poisons the process's context, so the worker exits after
reporting one, and the coordinator reaps it at once (event
``worker_lost``, why ``kernel error``) and respawns it within budget,
re-queuing nothing of the failed task.

Before the first spawn on a card the parent builds the kernels
(``kb.load()``), and every worker loads them before it reports ready: a
worker that cannot does not count as started.

Fault injection composes: per-worker :class:`~repro_torch.runtime.
faultinject.FaultSpec` lists (picklable — no lambdas; an
``exc_factory`` is a class such as ``_build.KernelLaunchError``) are
re-armed inside each spawned process.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import signal
import socket
import sys
import time
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.formats import CSR
from repro_torch.distributed import spgemm_shard as shard
from repro_torch.kernels import backend as kb
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime.elastic import remesh_lanes


class PoolLost(RuntimeError):
    """Every worker is dead and the restart budget is exhausted."""


# a worker's pipe is a Unix socketpair; a full-size flush moves ~300 MB
# over it (operands out, results back), which under gVisor's user-space
# kernel moved at ~8 MB/s with the default ~200 KB socket buffers and at
# ~200 MB/s with these
_PIPE_BUFFER_BYTES = 32 << 20


def _widen(conn) -> None:
    """Ask for ``_PIPE_BUFFER_BYTES`` socket buffers on ``conn``'s socket
    (the kernel may cap them, as Linux does at ``net.core.wmem_max``)."""
    s = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            s.setsockopt(socket.SOL_SOCKET, opt, _PIPE_BUFFER_BYTES)
    finally:
        s.close()


# ---------------------------------------------------------------------------
# task payloads: packed (host numpy) CSR pairs, picklable end to end
# ---------------------------------------------------------------------------


def pack_csr(m: CSR) -> tuple:
    """CSR -> (indptr, indices, data, shape), host numpy copies.

    No device tensor crosses the pipe: a card's tensors are copied to
    the host first (bit for bit, ``-0.0`` included)."""
    return (m.indptr.detach().cpu().numpy().copy(),
            m.indices.detach().cpu().numpy().copy(),
            m.data.detach().cpu().numpy().copy(), tuple(m.shape))


def unpack_csr(t: tuple, device) -> CSR:
    """Inverse of :func:`pack_csr`, placed on ``device``."""
    return CSR(*(torch.tensor(np.asarray(x)).to(device) for x in t[:3]),
               tuple(t[3]))


def make_flush_payload(reqs, *, bucket: tuple, engine: str, max_batch: int,
                       policy=None) -> dict:
    """Build a flush-task payload from service requests (id order kept).

    The policy's ``fallback=None`` ("the device's ``degrade_chain``")
    travels as None, so each worker walks its own device's chain."""
    payload: dict[str, Any] = {
        "bucket": bucket,
        "pairs": [(pack_csr(r.A), pack_csr(r.B)) for r in reqs],
        "engine": engine,
        "max_batch": max_batch,
    }
    if policy is not None:
        payload["policy"] = {
            "max_attempts": policy.max_attempts,
            "backoff_base_s": policy.backoff_base_s,
            "backoff_factor": policy.backoff_factor,
            "fallback": None if policy.fallback is None
            else tuple(policy.fallback),
        }
    return payload


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------


def _run_flush(payload: dict, *, cache, devices, caps: dict) -> dict:
    """Execute one flush task through a local SpGemmService on the
    worker's lane ``devices``.

    ``caps`` is the worker's *persistent* sticky-cap map (shared across
    tasks and with warm tasks).  Returns per-request outcomes (packed
    results or structured errors, id order preserved) plus the flush's
    provenance record, whose ``launches`` are this worker's kernel
    launch counts for the flush.  A kernel error raises out of the
    local service's ``drain``."""
    from repro_torch.core import dispatch as dp
    from repro_torch.serving.spgemm_service import SpGemmService

    pairs = payload["pairs"]
    pol = payload.get("policy")
    policy = dp.RetryPolicy(**pol) if pol else dp.RetryPolicy()
    bucket = payload.get("bucket")
    sticky = payload.get("sticky_cap")
    if bucket is not None and sticky:
        caps[bucket] = max(int(sticky), caps.get(bucket, 0))
    svc = SpGemmService(
        max_batch=max(int(payload.get("max_batch", len(pairs))), len(pairs)),
        flush_timeout=0.0, engine=payload.get("engine", "auto"),
        devices=devices, cache=cache, policy=policy, bucket_caps=caps)
    kb.reset_launch_counts()
    reqs = [svc.submit(unpack_csr(a, devices[0]), unpack_csr(b, devices[0]))
            for a, b in pairs]
    svc.drain()
    launches = {k: v for k, v in kb.launch_counts().items() if v}
    outcomes = []
    for r in reqs:
        if r.error is not None:
            outcomes.append({"ok": False, "stage": r.error.stage,
                             "kind": r.error.kind,
                             "message": r.error.message,
                             "attempts": r.error.attempts})
        else:
            outcomes.append({"ok": True, "result": pack_csr(r.result),
                             "engine": r.engine, "tier": r.tier})
    f = svc.flush_log[-1] if svc.flush_log else None
    flush = None
    if f is not None:
        flush = {"engine": f.engine, "source": f.source, "tier": f.tier,
                 "attempts": f.attempts, "errors": list(f.errors),
                 "wall_s": f.wall_s, "warm_hit": f.warm_hit,
                 "launches": launches}
    return {"outcomes": outcomes, "flush": flush}


def _run_warm(payload: dict, *, cache, devices, caps: dict) -> dict:
    """Execute one warm task: warm a pad bucket in this worker before its
    first flush arrives.

    Fires the ``service.warm`` fault site (chaos tests SIGKILL workers
    mid-warm here) and seeds the worker's persistent sticky-cap map, so
    the bucket's real flushes pin to the warmed plan identity."""
    from repro_torch.core import dispatch as dp

    bucket = payload["bucket"]
    fi.fire("service.warm", bucket=bucket)
    pair = payload.get("pair")
    sample = (unpack_csr(pair[0], devices[0]),
              unpack_csr(pair[1], devices[0])) if pair else None
    res = dp.warm_bucket(bucket, engine=payload.get("engine", "auto"),
                         max_batch=int(payload.get("max_batch", 8)),
                         cache=cache, devices=devices, sample=sample,
                         sticky_cap=payload.get("sticky_cap"))
    cap = res.get("cap")
    if cap:
        caps[bucket] = max(int(cap), caps.get(bucket, 0))
    return {"warm": res}


def _worker_main(conn, worker_id: int, init: dict) -> None:
    """Entry point of a spawned worker (module top level: picklable).

    Protocol (parent -> worker): ``("task", id, payload)``,
    ``("ping", seq)``, ``("remesh", n_lanes)``, ``("stop",)``.
    Worker -> parent: ``("ready", pid, n_devices)``,
    ``("result", id, out)``, ``("error", id, kind, message, kernel)``,
    ``("pong", seq)``.  One task at a time — parallelism is across
    workers, serialization within one is what makes re-queue exact.
    After reporting a kernel error (``kernel`` true) the worker exits:
    on a card its CUDA context may be poisoned."""
    for p in reversed(init.get("sys_path", [])):
        if p not in sys.path:
            sys.path.insert(0, p)
    specs = init.get("fault_specs") or []
    if specs:
        fi.install(fi.FaultInjector(
            specs, seed=int(init.get("fault_seed", 0)) + worker_id))
    # the device work before "ready": a worker that cannot load the
    # kernels does not count as started
    from repro_torch.core import dispatch as dp

    all_devs = [torch.device(d) for d in init["devices"]]
    if any(d.type == "cuda" for d in all_devs):
        kb.load()
    n_dev = len(all_devs)
    n_lanes = max(1, min(int(init.get("n_lanes", 1)), n_dev))
    devices = all_devs[:n_lanes]
    cache = (dp.AutotuneCache(init["cache_path"])
             if init.get("cache_path") else dp.default_cache())
    # sticky esc caps, persistent across this worker's tasks
    caps: dict = {}
    conn.send(("ready", os.getpid(), n_dev))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break  # parent is gone; nothing left to serve
        tag = msg[0]
        if tag == "stop":
            break
        if tag == "ping":
            conn.send(("pong", msg[1]))
            continue
        if tag == "remesh":
            n_lanes = max(1, min(int(msg[1]), n_dev))
            devices = all_devs[:n_lanes]
            continue
        # ("task", task_id, payload)
        _, task_id, payload = msg
        try:
            if payload.get("kind") == "warm":
                out = _run_warm(payload, cache=cache, devices=devices,
                                caps=caps)
            else:
                out = _run_flush(payload, cache=cache, devices=devices,
                                 caps=caps)
            conn.send(("result", task_id, out))
        except Exception as e:
            kernel = isinstance(e, kb.KERNEL_ERRORS)
            try:
                conn.send(("error", task_id, type(e).__name__, str(e),
                           kernel))
            except (OSError, ValueError):
                break
            if kernel:
                break
    try:
        conn.close()
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the coordinator (parent side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Task:
    id: int
    payload: dict
    tries: int = 0

    @property
    def bucket_id(self) -> Optional[str]:
        b = self.payload.get("bucket")
        return None if b is None else repr(b)


def _hrw(bucket_id: str, worker_id: int) -> int:
    """Rendezvous (highest-random-weight) score of a worker for a bucket.

    blake2s, not ``hash()``: stable across processes and
    PYTHONHASHSEED, so a bucket's affinity worker is reproducible and
    survives coordinator restarts.  The max-scoring *live* worker owns
    the bucket; when it dies, ownership falls to the runner-up without
    reshuffling anyone else (the rendezvous property)."""
    h = hashlib.blake2s(f"{bucket_id}|{worker_id}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


class _Worker:
    """Parent-side handle: process, pipe, budget, in-flight bookkeeping."""

    def __init__(self, worker_id: int):
        self.id = worker_id
        self.proc = None
        self.conn = None
        self.alive = False
        self.restarts = 0
        self.in_flight: dict[int, _Task] = {}
        self.dispatched_at: dict[int, float] = {}
        self.ping_sent: Optional[float] = None
        self.n_devices = 0
        # bucket ids this process has planned (reset on respawn: a fresh
        # process has cold plan memos and allocator)
        self.seen: set[str] = set()


class ProcessCoordinator:
    """Spawn, feed, and supervise a pool of SpGEMM worker processes.

    n_workers:           pool size.
    devices:             the lane devices (``shard.lane_devices``: every
                         card by default, or what the caller names, e.g.
                         ``["cpu"] * 4``); a worker's lane slice is the
                         first ``n`` of them.
    n_lanes:             device-lane space partitioned over the pool
                         (default: the number of lane devices).
    cache_path:          shared autotune/quarantine cache file; every
                         worker opens its own ``AutotuneCache`` on it.
    fault_specs:         chaos: a list of picklable ``FaultSpec``s armed
                         in every worker, or a dict ``{worker_id:
                         [specs]}`` for targeted faults.  Re-armed on
                         restart.
    max_worker_restarts: respawn budget *per worker slot*.
    max_task_retries:    re-dispatch budget per task before it is
                         returned as ``pool_lost``.
    affinity_spill:      backlog depth at a bucket's affinity worker
                         past which its task may spill to a cold idle
                         worker.
    task_timeout_s:      age at which an in-flight task declares its
                         worker hung (None disables).
    heartbeat_timeout_s: unanswered-ping age at which an *idle* worker
                         is declared dead.
    start_timeout_s:     max wait for a spawned worker's ready handshake
                         (a worker on a card initialises CUDA and loads
                         the kernels first).
    """

    def __init__(self, n_workers: int, *,
                 devices=None,
                 n_lanes: Optional[int] = None,
                 cache_path: Optional[str] = None,
                 fault_specs: Union[Sequence[fi.FaultSpec],
                                    dict, None] = None,
                 fault_seed: int = 0,
                 max_worker_restarts: int = 3,
                 max_task_retries: int = 3,
                 affinity_spill: int = 2,
                 task_timeout_s: Optional[float] = 120.0,
                 heartbeat_timeout_s: float = 10.0,
                 start_timeout_s: float = 120.0):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.devices = shard.lane_devices(devices)
        if n_lanes is None:
            n_lanes = len(self.devices)
        self.n_lanes = max(1, int(n_lanes))
        self.cache_path = cache_path
        self.fault_specs = fault_specs
        self.fault_seed = fault_seed
        self.max_worker_restarts = max_worker_restarts
        self.max_task_retries = max_task_retries
        self.affinity_spill = max(int(affinity_spill), 1)
        self.task_timeout_s = task_timeout_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.start_timeout_s = start_timeout_s
        self._ctx = mp.get_context("spawn")
        self._workers = [_Worker(i) for i in range(n_workers)]
        self._queue: collections.deque[_Task] = collections.deque()
        self._next_task = 0
        self.events: list[dict] = []  # supervision log (tests assert on it)
        if any(d.type == "cuda" for d in self.devices):
            kb.load()  # build once, before any worker loads the kernels
        lanes = self._partition(n_workers)
        # start every worker, then take the handshakes in worker order:
        # the workers import and initialise in parallel
        for w, nl in zip(self._workers, lanes):
            self._start(w, nl)
        for w, nl in zip(self._workers, lanes):
            self._handshake(w, nl)
        if not self._alive():
            raise PoolLost("no worker survived startup")

    # -- membership ------------------------------------------------------

    def _alive(self) -> list[_Worker]:
        return [w for w in self._workers if w.alive]

    @property
    def alive_count(self) -> int:
        return len(self._alive())

    def _partition(self, n: int) -> list[int]:
        return [len(r) for r in remesh_lanes(self.n_lanes, max(n, 1))]

    def _specs_for(self, worker_id: int) -> list:
        s = self.fault_specs
        if s is None:
            return []
        if isinstance(s, dict):
            s = s.get(worker_id, [])
        # fresh copies: fire counters must not leak across restarts or
        # into the parent's own spec objects
        return [dataclasses.replace(spec, fires=0) for spec in s]

    def _start(self, w: _Worker, n_lanes: int) -> None:
        init = {
            "sys_path": list(sys.path),
            "devices": [str(d) for d in self.devices],
            "cache_path": self.cache_path,
            "n_lanes": n_lanes,
            "fault_specs": self._specs_for(w.id),
            "fault_seed": self.fault_seed,
        }
        parent_conn, child_conn = self._ctx.Pipe()
        for c in (parent_conn, child_conn):
            _widen(c)
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child_conn, w.id, init), daemon=True)
        proc.start()
        child_conn.close()  # our copy — EOF must propagate on child death
        w.proc, w.conn = proc, parent_conn
        w.ping_sent = None
        w.seen = set()

    def _handshake(self, w: _Worker, n_lanes: int) -> bool:
        if not w.conn.poll(self.start_timeout_s):
            self._kill(w)
            self.events.append({"event": "start_timeout", "worker": w.id})
            return False
        try:
            tag, pid, n_dev = w.conn.recv()
        except (EOFError, OSError):
            self._kill(w)
            self.events.append({"event": "start_died", "worker": w.id})
            return False
        w.alive = tag == "ready"
        w.n_devices = n_dev
        self.events.append({"event": "spawn", "worker": w.id, "pid": pid,
                            "n_lanes": n_lanes})
        return w.alive

    def _spawn(self, w: _Worker, n_lanes: int) -> bool:
        self._start(w, n_lanes)
        return self._handshake(w, n_lanes)

    def _kill(self, w: _Worker) -> None:
        w.alive = False
        if w.proc is not None and w.proc.is_alive():
            try:
                os.kill(w.proc.pid, signal.SIGKILL)
            except (OSError, TypeError):
                pass
        if w.proc is not None:
            w.proc.join(timeout=5.0)
        if w.conn is not None:
            try:
                w.conn.close()
            except OSError:
                pass
        w.conn = None

    def _remesh(self) -> None:
        """Re-partition lanes over the live workers and tell each one."""
        alive = self._alive()
        if not alive:
            return
        lanes = self._partition(len(alive))
        for w, nl in zip(alive, lanes):
            try:
                w.conn.send(("remesh", nl))
            except (OSError, ValueError):
                pass  # a dying worker is caught by the next poll
        self.events.append({"event": "remesh", "workers": len(alive),
                            "lanes": lanes})

    def _on_worker_lost(self, w: _Worker, why: str,
                        out: list) -> None:
        """Requeue a dead worker's tasks, respawn within budget, remesh."""
        orphans = list(w.in_flight.values())
        w.in_flight.clear()
        w.dispatched_at.clear()
        self._kill(w)
        self.events.append({"event": "worker_lost", "worker": w.id,
                            "why": why, "orphans": [t.id for t in orphans]})
        if w.restarts < self.max_worker_restarts:
            w.restarts += 1
            n = self._partition(len(self._alive()) + 1)[-1]
            if self._spawn(w, n):
                self.events.append({"event": "restart", "worker": w.id,
                                    "n": w.restarts})
        # a killed worker's buckets re-run on survivors — preferring a
        # different worker, so a task that keeps killing its host makes
        # progress instead of chasing the respawn
        for t in orphans:
            t.tries += 1
            if t.tries > self.max_task_retries:
                self.events.append({"event": "task_abandoned", "task": t.id})
                out.append((t.id, {"pool_lost": True,
                                   "why": f"retries exhausted ({why})"}))
            elif not self._dispatch(t, avoid=w.id):
                self._queue.append(t)
        self._remesh()

    # -- dispatch --------------------------------------------------------

    def _dispatch(self, t: _Task, avoid: Optional[int] = None,
                  prefer: Optional[int] = None) -> bool:
        """Route one task to a worker; False keeps it queued.

        Bucketed tasks (flushes and warms) go to their **affinity
        worker** (rendezvous hash over the live set).  When the affinity
        worker is busy, another *idle* worker that already saw the bucket
        may take it; a cold idle worker only gets it once the affinity
        worker's backlog reaches ``affinity_spill``.  Otherwise the task
        stays queued.  Bucketless tasks fall back to least-loaded."""
        alive = [w for w in self._alive() if w.id != avoid] or self._alive()
        if not alive:
            return False
        w = None
        preferred = [x for x in alive if x.id == prefer]
        bid = t.bucket_id
        if preferred:
            w = preferred[0]
        elif bid is not None:
            aff = max(alive, key=lambda x: _hrw(bid, x.id))
            if not aff.in_flight:
                w = aff
            else:
                warm_idle = [x for x in alive
                             if bid in x.seen and not x.in_flight]
                idle = [x for x in alive if not x.in_flight]
                if warm_idle:
                    w = max(warm_idle, key=lambda x: _hrw(bid, x.id))
                elif idle and len(aff.in_flight) >= self.affinity_spill:
                    w = max(idle, key=lambda x: _hrw(bid, x.id))
                else:
                    return False  # hold for the worker that owns it
        else:
            w = min(alive, key=lambda x: len(x.in_flight))
        try:
            w.conn.send(("task", t.id, t.payload))
        except (OSError, ValueError):
            return False  # worker died under us; poll will reap it
        w.in_flight[t.id] = t
        w.dispatched_at[t.id] = time.monotonic()
        if bid is not None:
            w.seen.add(bid)
        return True

    def _drain_queue(self) -> None:
        # scan the whole queue, not just the head: affinity can block
        # the head task (its owner is busy) while a later task's owner
        # sits idle
        if not self._queue:
            return
        held = []
        while self._queue:
            t = self._queue.popleft()
            if not self._dispatch(t):
                held.append(t)
        self._queue.extend(held)

    def submit(self, payload: dict,
               prefer: Optional[int] = None) -> int:
        """Queue one task; returns its task id.

        ``prefer`` pins the task to a worker id when that worker is
        live.  Raises :class:`PoolLost` when no worker is live — the
        caller's in-process ladder takes over."""
        if not self._alive():
            raise PoolLost("no live workers")
        t = _Task(self._next_task, payload)
        self._next_task += 1
        if not self._dispatch(t, prefer=prefer):
            self._queue.append(t)
        return t.id

    @property
    def in_flight(self) -> int:
        return len(self._queue) + sum(len(w.in_flight)
                                      for w in self._workers)

    # -- supervision loop ------------------------------------------------

    def _handle(self, w: _Worker, msg: tuple, out: list) -> None:
        tag = msg[0]
        if tag == "pong":
            w.ping_sent = None
            return
        if tag == "result":
            _, tid, res = msg
            t = w.in_flight.pop(tid, None)
            w.dispatched_at.pop(tid, None)
            if t is not None:
                out.append((tid, res))
            return
        if tag == "error":
            _, tid, kind, message, kernel = msg
            t = w.in_flight.pop(tid, None)
            w.dispatched_at.pop(tid, None)
            self.events.append({"event": "task_error", "task": tid,
                                "worker": w.id, "kind": kind})
            if t is not None:
                out.append((tid, {"error": {"kind": kind,
                                            "message": message,
                                            "worker": w.id,
                                            "kernel": kernel}}))
            if kernel:
                # the worker exits after a kernel error (its CUDA context
                # may be poisoned): reap and respawn it now; the failed
                # task is not re-queued, it was answered above
                self._on_worker_lost(w, f"kernel error ({kind})", out)

    def _check_hangs(self, out: list) -> None:
        if self.task_timeout_s is None:
            return
        now = time.monotonic()
        for w in self._alive():
            if w.dispatched_at and \
                    now - min(w.dispatched_at.values()) > self.task_timeout_s:
                self._on_worker_lost(w, "task timeout", out)

    def poll(self, timeout: float = 0.0) -> list[tuple[int, dict]]:
        """Drain finished tasks: [(task_id, result_dict)].

        A result dict is the worker's ``{"outcomes": ..., "flush": ...}``
        (or ``{"warm": ...}``) on success, ``{"error": {"kind",
        "message", "worker", "kernel"}}`` on a failure inside a live
        worker, or ``{"pool_lost": True, ...}`` when the task ran out of
        workers to die on.  Death, hang, and restart handling all happen
        inside this call."""
        out: list[tuple[int, dict]] = []
        deadline = time.monotonic() + max(0.0, timeout)
        while True:
            conns = {w.conn: w for w in self._alive()}
            if not conns:
                # total pool loss: hand every remaining task back
                for t in list(self._queue):
                    out.append((t.id, {"pool_lost": True,
                                       "why": "no live workers"}))
                self._queue.clear()
                return out
            wait_s = max(0.0, deadline - time.monotonic())
            ready = mpc.wait(list(conns), timeout=wait_s)
            for conn in ready:
                w = conns[conn]
                if w.conn is not conn:
                    continue  # reaped by an earlier message of this round
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    code = w.proc.exitcode if w.proc is not None else None
                    self._on_worker_lost(w, f"pipe EOF (exit {code})", out)
                    continue
                self._handle(w, msg, out)
            self._check_hangs(out)
            self._drain_queue()
            if out or time.monotonic() >= deadline:
                return out

    def heartbeat(self) -> None:
        """Ping idle workers; reap the ones that stopped answering.

        Busy workers are covered by ``task_timeout_s`` — a worker
        grinding a flush cannot answer pings and must not die for it."""
        now = time.monotonic()
        for w in self._alive():
            if w.in_flight:
                continue
            if w.ping_sent is None:
                try:
                    w.conn.send(("ping", now))
                    w.ping_sent = now
                except (OSError, ValueError):
                    self._on_worker_lost(w, "ping send failed", [])
            elif now - w.ping_sent > self.heartbeat_timeout_s:
                self._on_worker_lost(w, "heartbeat timeout", [])

    # -- lifecycle -------------------------------------------------------

    def shutdown(self) -> None:
        for w in self._workers:
            if w.alive and w.conn is not None:
                try:
                    w.conn.send(("stop",))
                except (OSError, ValueError):
                    pass
        for w in self._workers:
            if w.proc is not None:
                w.proc.join(timeout=5.0)
            self._kill(w)

    def __enter__(self) -> "ProcessCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
