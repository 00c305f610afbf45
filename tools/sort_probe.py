#!/usr/bin/env python3
"""Time K1 and K4 and the calls that launch them, on one card.

K1 (``repro_torch.kernels.chunk_sort``) sorts the chunks of the spz
driver's large-route buckets; K4 (``repro_torch.kernels.stream_sort``)
sorts every chunk column of the spz-host driver.  This script measures
both on the tree whose ``src/`` it is given, so two trees can be compared
inside one chip call (parent, change, change, parent).  The measurements
are ``chip_smoke.py``'s own, imported from this checkout's copy:

  kernels  K1 at N = 8,192 and 65,536 chunks of R = 16 (one S = 512,
           L = 256 or 2,048 bucket from a seed, ``chip_smoke._bucket``)
           and K4 at S = 512,
           R = 16, each held bit for bit against its plain version and
           timed alone between events (``ms``), as the device time of
           100 launches replayed from one CUDA graph (``device_ms``) and
           through its wrapper (``wrapper_ms``)
  sweep    where the tree's launcher takes a launch shape, ``device_ms``
           of every (slots a lane, warps a block) of the warp route at
           these shapes, each held against the plain version too
  floor    where the tree has it, the same device time of an empty kernel
  calls    three warm ``spz-host`` calls on cage11-full and three warm
           ``spz`` calls on dense-row-full (host clock, median), then
           under ``chip_smoke._profiled`` one ``spz`` call on
           dense-row-full (K1's device total) and one ``spz-host`` call on
           the first 8 groups of cage11-full (K4's device total)

It prints the card's name and power limit, then one JSON object.

Run: ``python3 tools/sort_probe.py [--src SRC_DIR]`` (one card).
"""
import argparse
import inspect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel names of the sort kernels, in this tree and the one before it
SORT_KERNELS = ("sort_warp_kernel", "sort_block_kernel", "chunk_sort_kernel",
                "stream_sort_kernel")


def _sort_total(prof):
    """(device ms, launches) of the sort kernels in a profiled call."""
    hits = [(c, t) for key, (c, t) in prof["kernels"].items()
            if any(k in key for k in SORT_KERNELS)]
    return sum(t for _, t in hits), sum(c for c, _ in hits)


def _warm_ms(spgemm, A, engine, n=3):
    spgemm(A, A, engine=engine)  # warm
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        spgemm(A, A, engine=engine)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src/ first on the path

    sys.path.insert(0, os.path.abspath(args.src))  # ahead of it
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sort_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import spgemm
    from repro_torch.data import table3
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_sort as k1
    from repro_torch.kernels import stream_sort as k4

    dev = torch.device("cuda")
    res = {"src": os.path.abspath(args.src)}
    R = 16
    rng = np.random.default_rng(cs.SEED)
    keys, vals, plens = (torch.from_numpy(a).to(dev) for a in
                         cs._bucket(np, rng, 512, 256, 39082))
    k1_args = (keys.view(-1, R), vals.view(-1, R), k1.chunk_lens(plens, 16, R))
    k4_args = tuple(torch.from_numpy(a).to(dev) for a in
                    cs._bucket(np, rng, 512, R, 39082))
    keys, vals, plens = (torch.from_numpy(a).to(dev) for a in
                         cs._bucket(np, rng, 512, 2048, 39082))
    k1w_args = (keys.view(-1, R), vals.view(-1, R),
                k1.chunk_lens(plens, 128, R))
    for name, mod, fn, plain, a in (
            ("k1", k1, k1.chunk_sort, k1.chunk_sort_plain, k1_args),
            ("k1_wide", k1, k1.chunk_sort, k1.chunk_sort_plain, k1w_args),
            ("k4", k4, k4.stream_sort, k4.stream_sort_plain, k4_args)):
        want = plain(*a)
        cs.max_abs_err(torch, fn(*a), want)
        outs = [torch.empty_like(t) for t in want]
        row = dict(
            shape=f"{a[0].shape[0]}x{R}",
            ms=cs.time_ms(torch, lambda: mod.launch(*a, *outs), reps=50,
                          warmup=5),
            device_ms=cs.graph_ms(torch, lambda: mod.launch(*a, *outs)),
            wrapper_ms=cs.time_ms(torch, lambda: fn(*a), reps=50, warmup=5))
        if "config" in inspect.signature(mod.launch).parameters:
            row["config"] = k1.sort_config(a[0].numel(), R)
            sweep = {}
            for items in (1, 2, 4, 8):
                for warps in (1, 2, 4):
                    cfg = (items, warps)
                    mod.launch(*a, *outs, config=cfg)
                    cs.max_abs_err(torch, outs, want)
                    sweep[f"{items}x{warps}"] = cs.graph_ms(
                        torch, lambda: mod.launch(*a, *outs, config=cfg))
            row["sweep_device_ms"] = sweep
        res[name] = row
    if hasattr(_build, "entry"):
        res["launch_floor_ms"] = cs.launch_floor_ms(torch, _build)

    A = table3.build("cage11-full")
    ms, times = _warm_ms(spgemm, A, "spz-host")
    res["spz_host_cage11_full"] = dict(ms=ms, times=times)
    D = table3.build(table3.LONG_ROW)
    ms, times = _warm_ms(spgemm, D, "spz")
    res["spz_dense_row_full"] = dict(ms=ms, times=times)
    for key, label, M, B, engine in (
            ("spz_dense_row_full", "dense-row-full spz", D, D, "spz"),
            ("spz_host_cage11_full", "cage11-full rows 0-4095 spz-host",
             cs._rows(A, 8 * 512), A, "spz-host")):
        spgemm(M, B, engine=engine)  # warm
        prof = cs._profiled(torch, label, lambda: spgemm(M, B, engine=engine))
        if prof is None:
            raise RuntimeError("the profiler recorded no device time")
        t, n = _sort_total(prof)
        res[key].update(profiled=label, sort_device_ms=t, sort_launches=n,
                        sort_device_ms_per_launch=t / n if n else None,
                        busy_ms=prof["busy"], wall_ms=prof["wall"],
                        launches=prof["launches"])
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
