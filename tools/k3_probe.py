#!/usr/bin/env python3
"""Time K3 and its share of one ``spz`` call, on one card.

K3 (``repro_torch.kernels.fused_bucket``) runs every bucket of the fused
spz driver up to L = 8,192.  This script measures it on the tree whose
``src/`` it is given, so two trees can be compared inside one chip call
(parent, change, change, parent).  The measurements are
``chip_smoke.py``'s own, imported from this checkout's copy:

  streams  K3's streams entry alone (``fused_bucket.launch``) on one
           S = 512, L = 1,024, R = 16 bucket from a seed
           (``chip_smoke._bucket``), held against the plain version
  expand   where the tree has it, K3's expand entry on the buckets of
           ``chip_smoke.k3_expand_rows``
  spz      three warm ``spgemm(A, A, engine="spz")`` calls on
           cage11-full and email-Enron-full (host clock), then one under
           ``chip_smoke._profiled``: device launches, busy time, idle
           share, K3's device total and launches per bucket

It prints the card's name and power limit, then one JSON object.

Run: ``python3 tools/k3_probe.py [--src SRC_DIR]`` (one card).
"""
import argparse
import inspect
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import spgemm
    from repro_torch.core import spgemm_engines as sg
    from repro_torch.data import table3
    from repro_torch.kernels import fused_bucket as k3

    dev = torch.device("cuda")
    res = {"src": os.path.abspath(args.src)}
    rng = np.random.default_rng(cs.SEED)
    keys, vals, plens = (torch.from_numpy(a).to(dev) for a in
                         cs._bucket(np, rng, 512, 1024, 39082))
    got = k3.fused_bucket(keys, vals, plens, R=16, detailed=True)
    want = k3.fused_bucket_plain(keys, vals, plens, R=16, detailed=True)
    cs.max_abs_err(torch, got[:3], want[:3])
    outs = [torch.empty_like(t) for t in got[:3]]
    if "planes" in inspect.signature(k3.launch).parameters:
        buf = torch.zeros((4, 512, 63), dtype=torch.int32, device=dev)
    else:
        buf = k3.accumulators(64, dev)[0]
    res["streams_ms"] = cs.time_ms(
        torch, lambda: k3.launch(keys, vals, plens, 16, *outs, buf),
        reps=20, warmup=3)
    if hasattr(k3, "fused_expand_bucket"):
        res["expand"] = {k: {x: r[x] for x in ("ms", "bound_ms", "shape")}
                         for k, r in cs.k3_expand_rows(torch, np, k3).items()}
    for n in ("cage11-full", "email-Enron-full"):
        A = table3.build(n)
        work = sg.row_work(A, A)
        buckets = sum(len({sg._pow2_chunks(int(w), 16)
                           for w in work[g:g + 512] if w})
                      for g in range(0, len(work), 512))
        spgemm(A, A, engine="spz")  # warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            spgemm(A, A, engine="spz")
            times.append((time.perf_counter() - t0) * 1e3)
        prof = cs._profiled(torch, f"{n} spz",
                            lambda: spgemm(A, A, engine="spz"))
        if prof is None:
            raise RuntimeError("the profiler recorded no device time")
        k3k = [(c, t) for key, (c, t) in prof["kernels"].items()
               if "fused_bucket" in key]
        res[n] = dict(
            ms=statistics.median(times), times=times, buckets=buckets,
            launches=prof["launches"], busy_ms=prof["busy"],
            wall_ms=prof["wall"], idle=1 - prof["busy"] / prof["wall"],
            launches_per_bucket=prof["launches"] / buckets,
            k3_ms=sum(t for _, t in k3k), k3_launches=sum(c for c, _ in k3k))
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
