"""Continuous SpGEMM serving CLI: synthetic mixed traffic -> SpGemmService.

Port of ``repro.launch.serve_spgemm``.  Generates a stream of
mixed-shape, mixed-density sparse multiply requests (the request mix the
dispatch heuristics distinguish), feeds them through the bucketed
service with work-balanced lane sharding, and reports throughput,
latency percentiles, and the per-bucket outcomes.  Runs on the card by
default; ``--device cpu`` runs on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --requests 200
  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --device cpu \\
      --requests 40 --verify

Chaos mode injects kernel faults (and optionally a worker kill) while
serving, and reports availability, degraded-tier traffic, and the
dead-letter queue:

  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --requests 200 \\
      --inject-rate 0.1 --kill-worker 0 --deadline 30 --max-attempts 3

Async + warm mode keeps admission non-blocking (flushes on a thread
pool) and warms the traffic mix's pad buckets before the first request:

  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --requests 200 \\
      --async-flushes 2 --warm

Multi-process mode spreads flushes over a supervised pool of spawned
worker processes (``runtime/coordinator.py``), every worker on the
service's lane devices (on one card, all share it); ``--kill-worker-proc``
SIGKILLs worker process 0 mid-flush (the flush re-runs on a survivor;
availability stays 1.0):

  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --requests 200 \\
      --workers 2
  PYTHONPATH=src python -m repro_torch.launch.serve_spgemm --device cpu \\
      --requests 40 --workers 2 --kill-worker-proc --inject-rate 0.1
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import dispatch as dp
from repro_torch.core.formats import random_sparse
from repro_torch.core.spgemm import spgemm_scl_array
from repro_torch.distributed import spgemm_shard as shard
from repro_torch.runtime import faultinject as fi
from repro_torch.runtime.coordinator import ProcessCoordinator
from repro_torch.serving.plan_warmer import PlanWarmer
from repro_torch.serving.spgemm_service import SpGemmService

# (n, density, pattern) mix spanning the heuristic table's regimes
TRAFFIC_MIX = (
    (64, 0.004, "uniform"),
    (64, 0.05, "uniform"),
    (96, 0.02, "powerlaw"),
    (96, 0.008, "banded"),
    (128, 0.01, "uniform"),
    (128, 0.03, "powerlaw"),
)

def make_traffic(n_requests: int, seed: int = 0) -> list:
    """Pre-generate (A, B) request pairs drawn from the traffic mix, on
    the CPU (the reference's draws, so the same pairs)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_requests):
        n, dens, pattern = TRAFFIC_MIX[int(rng.integers(len(TRAFFIC_MIX)))]
        # jitter density a little so nnz varies inside each pad bucket
        d = dens * float(rng.uniform(0.8, 1.2))
        A = random_sparse(n, n, d, seed=int(rng.integers(1 << 30)),
                          pattern=pattern)
        pairs.append((A, A))
    return pairs


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="serve synthetic SpGEMM traffic through the "
                    "plan/execute + lane-sharding stack")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=0.05,
                    help="bucket flush timeout, seconds")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--warmup", type=int, default=None,
                    help="requests to exclude from steady-state stats "
                         "(default: a quarter of the stream)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None,
                    help="autotune cache path (default: a fresh temp "
                         "cache, so the warm-up->steady-state ramp is "
                         "visible)")
    ap.add_argument("--verify", action="store_true",
                    help="check every result against the scl-array oracle")
    ap.add_argument("--inject-rate", type=float, default=0.0,
                    help="probability a batched kernel launch raises an "
                         "injected fault (chaos mode)")
    ap.add_argument("--kill-worker", type=int, default=None, metavar="DEV",
                    help="kill shard worker DEV once, mid-serve")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline, seconds (expired requests "
                         "dead-letter)")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="per-flush attempts on the planned tier before "
                         "walking the degradation ladder")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the fault-injection RNG")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="multi-process mode: dispatch flushes to a "
                         "supervised pool of N spawned worker processes "
                         "(0 = in-process serving)")
    ap.add_argument("--kill-worker-proc", action="store_true",
                    help="SIGKILL worker process 0 once, mid-flush "
                         "(requires --workers >= 1)")
    ap.add_argument("--async-flushes", type=int, default=0, metavar="N",
                    help="run flushes on an executor pool of N threads: "
                         "admission never blocks on execution and "
                         "concurrent buckets overlap (0 = synchronous "
                         "inline flushes; not with --workers, where the "
                         "process pool is the async vehicle)")
    ap.add_argument("--warm", action="store_true",
                    help="warm the traffic mix's pad buckets (plus their "
                         "pow2 neighbors) before the first request, and "
                         "keep warming buckets predicted from the "
                         "admission stream")
    ap.add_argument("--device", default="cuda",
                    help="where to serve: cuda (the card, default) or cpu")
    return ap


def run(argv=None) -> dict:
    """Serve the traffic ``argv`` describes and print the report; returns
    ``{"service", "wall_s", "warm_s", "snap", "all", "steady", "pool"}``
    (the closed service, the stats of every request and of the steady
    state after the warm-up window, and under ``--workers`` the pool's
    startup seconds, supervision events and live workers at drain)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.workers > 0 and args.async_flushes > 0:
        ap.error("--async-flushes and --workers exclude each other: the "
                 "process pool is the async vehicle")
    devices = shard.lane_devices(args.device)
    cache = dp.AutotuneCache(args.cache or os.path.join(
        tempfile.mkdtemp(prefix="serve_spgemm_"), "autotune.json"))
    policy = dp.RetryPolicy(max_attempts=args.max_attempts,
                            deadline_s=args.deadline)
    coordinator, pool = None, None
    if args.workers > 0:
        # chaos specs are re-armed *inside* each worker process (they
        # must be picklable, so the in-process kill_worker_spec does not
        # apply there; --kill-worker-proc kills the real process)
        pool_specs: dict = {}
        if args.inject_rate > 0.0:
            common = [fi.FaultSpec(site="kernel.batched", kind="raise",
                                   rate=args.inject_rate)]
            pool_specs = {i: list(common) for i in range(args.workers)}
        if args.kill_worker_proc:
            pool_specs.setdefault(0, []).append(
                fi.FaultSpec(site="service.flush", kind="kill_process",
                             max_fires=1))
        t_pool = time.perf_counter()
        coordinator = ProcessCoordinator(
            args.workers, devices=list(devices), cache_path=cache.path,
            fault_specs=pool_specs or None,
            fault_seed=args.chaos_seed)
        pool = {"start_s": time.perf_counter() - t_pool}
        print(f"# pool: {args.workers} workers on {devices[0]} started in "
              f"{pool['start_s']:.2f}s")
    warmer = None
    if args.warm:
        # one representative pair per traffic class, at nominal density;
        # neighbor warming covers the jittered pow2 boundaries
        reps = [(random_sparse(n, n, d, seed=7 + i, pattern=p),) * 2
                for i, (n, d, p) in enumerate(TRAFFIC_MIX)]
        warmer = PlanWarmer(configured=reps)
    service = SpGemmService(max_batch=args.max_batch,
                            flush_timeout=args.timeout,
                            engine=args.engine, devices=devices, cache=cache,
                            policy=policy, coordinator=coordinator,
                            async_flushes=args.async_flushes,
                            warmer=warmer)
    warm_s = None
    try:
        if args.warm:
            t_warm = time.perf_counter()
            n_warmed = service.prewarm()
            warm_s = time.perf_counter() - t_warm
            print(f"# prewarmed {n_warmed} pad buckets in {warm_s:.2f}s "
                  f"({warmer.stats()['failed']} failed)")
        specs = []
        if args.workers == 0 and args.inject_rate > 0.0:
            specs.append(fi.FaultSpec(site="kernel.batched", kind="raise",
                                      rate=args.inject_rate))
        if args.kill_worker is not None:
            specs.append(shard.kill_worker_spec(args.kill_worker))
        chaos = fi.injected(*specs, seed=args.chaos_seed) if specs \
            else contextlib.nullcontext()
        traffic = make_traffic(args.requests, seed=args.seed)
        warmup = args.warmup if args.warmup is not None \
            else args.requests // 4
        print(f"# serving {args.requests} requests on {devices[0]} "
              f"({len(TRAFFIC_MIX)} traffic classes, max_batch="
              f"{args.max_batch}, timeout={args.timeout}s)")
        t0 = time.perf_counter()
        snap = (0, 0)
        with chaos:
            for i, (A, B) in enumerate(traffic):
                service.submit(A, B)
                service.pump()
                if i + 1 == warmup:
                    # close out the warm-up window: flush the partial
                    # buckets so every bucket's plan is cached before the
                    # steady-state clock
                    service.drain()
                    snap = (len(service.completed), len(service.flush_log))
            service.drain()
        wall = time.perf_counter() - t0
    finally:
        service.close()
        if coordinator is not None:
            pool["events"] = list(coordinator.events)
            pool["alive"] = coordinator.alive_count
            coordinator.shutdown()
    if pool is not None:
        events = [e["event"] for e in pool["events"]]
        print(f"# pool: {args.workers} workers, {pool['alive']} alive at "
              "drain | events: "
              + ",".join(f"{e}x{events.count(e)}"
                         for e in sorted(set(events))))

    full = service.stats()
    steady = service.stats(since_request=snap[0], since_flush=snap[1])
    print(f"wall: {wall:.2f}s total, {args.requests / wall:.1f} req/s "
          "(including first plans)")
    for label, s in (("all", full), ("steady", steady)):
        if "req_per_s" not in s:
            continue
        print(f"{label}: {s['n_requests']} reqs in {s['n_flushes']} flushes "
              f"over {s['n_buckets']} buckets | "
              f"req/s={s['req_per_s']:.1f} | "
              f"p50={s['p50_latency_s'] * 1e3:.2f}ms "
              f"p95={s['p95_latency_s'] * 1e3:.2f}ms "
              f"p99={s['p99_latency_s'] * 1e3:.2f}ms | "
              f"plan_hit_rate={s.get('plan_hit_rate', 0.0):.2f}"
              + (f" | warm_hit_rate={s.get('warm_hit_rate', 0.0):.2f}"
                 if args.warm else ""))
    if args.inject_rate > 0.0 or args.kill_worker is not None \
            or args.kill_worker_proc:
        tiers: dict = {}
        for r in service.completed:
            tiers[r.tier] = tiers.get(r.tier, 0) + 1
        print(f"chaos: availability={full.get('availability', 1.0):.4f} "
              f"({full['n_dead_letters']} dead-lettered, "
              f"{full['n_degraded']} degraded) | tiers="
              + ",".join(f"{t}x{c}" for t, c in sorted(tiers.items())))
        for r in service.dead_letters:
            print(f"  dead-letter: {r.error}")
    print("# per-bucket outcomes (shape, nnz pad buckets -> engines)")
    for key, b in sorted(service.bucket_outcomes().items()):
        (na, _), (nb, _), cap_a, cap_b = key
        engines = ",".join(f"{e}x{c}" for e, c in sorted(b["engines"].items()))
        print(f"  {na}x{nb} pad=({cap_a},{cap_b}): {b['requests']} reqs / "
              f"{b['flushes']} flushes, hits={b['plan_hits']}, "
              f"engines={engines}")

    if args.verify:
        for r in service.completed:
            want = spgemm_scl_array(r.A, r.B).to_dense().numpy()
            got = r.result.to("cpu").to_dense().numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        print(f"verified {len(service.completed)} results against "
              "the scl-array oracle")
    return {"service": service, "wall_s": wall, "warm_s": warm_s,
            "snap": snap, "all": full, "steady": steady, "pool": pool}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
