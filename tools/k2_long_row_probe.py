#!/usr/bin/env python3
"""Time K2's long-row launch and its share of one ``spz`` call, on one card.

K2 (``repro_torch.kernels.merge_partitions``) merges rows of more than
4,096 slots on its long-row route.  This script measures that route on
the tree whose ``src/`` it is given, so two trees can be compared inside
one chip call (parent, change, change, parent).  The measurements are
``chip_smoke.py``'s own, imported from this checkout's copy:

  launch   ``chip_smoke.k2_long_row``: one row of La = Lb = 2^19 slots
           with <= 39,082 valid keys a side, from a seed, held bit for
           bit against the plain version, timed with the counters (ms)
           and without (payload_ms)
  profile  one warm ``spgemm(A, A, engine="spz")`` on ``dense-row-full``
           under ``chip_smoke._profiled``: K2's device total
           (``chip_smoke.k2_device_total``) and the (N, La, Lb) of each
           K2 launch

It prints the card's name and power limit, then one JSON object.

Run: ``python3 tools/k2_long_row_probe.py [--src SRC_DIR]`` (one card).
"""
import argparse
import json
import os
import sys

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
        print("k2_long_row_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import spgemm
    from repro_torch.data import table3
    from repro_torch.kernels import merge_partitions as k2

    res = {"src": os.path.abspath(args.src)}
    res["launch"] = cs.k2_long_row(torch, np, np.random.default_rng(cs.SEED),
                                   k2, 16)

    shapes = []
    launch = k2.launch

    def recording(ka, va, la, kb, *rest):
        shapes.append((ka.shape[0], ka.shape[1], kb.shape[1]))
        return launch(ka, va, la, kb, *rest)

    A = table3.build(table3.LONG_ROW)
    spgemm(A, A, engine="spz")  # warm
    k2.launch = recording
    try:
        prof = cs._profiled(torch, f"{table3.LONG_ROW} spz",
                            lambda: spgemm(A, A, engine="spz"))
    finally:
        k2.launch = launch
    if prof is None:
        raise RuntimeError("the profiler recorded no device time")
    ms, n, kernels = cs.k2_device_total(prof, f"{table3.LONG_ROW} spz")
    res["spz_dense_row_full"] = {
        "k2_device_ms": ms, "k2_launches": n, "k2_kernels": kernels,
        "k2_wrapper_calls": len(shapes),
        "long_route_calls": sum(La + Lb > 4096 for _, La, Lb in shapes),
        "shapes": sorted({s: shapes.count(s) for s in shapes}.items()),
    }
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
