#!/usr/bin/env python3
"""Time K7 (the grouped matmul) at the MoE paths' four launches, on one card.

K7 (``repro_torch.kernels.grouped_matmul``) runs the expert products of
the MoE block in the counts layout.  This script times it, and
``torch.bmm`` over the same (E, cap, .) buffers beside it, on the tree
whose ``src/`` it is given, so two trees can be compared inside one chip
call (parent, change, change, parent):

  deepseek        DeepSeek-V2's prefill w1 product: 160 experts, cap 96,
                  D 5,120 -> F 1,536, bf16
  backward        its dx = dy W1^T: dy (160 x 96, 1,536) against W1 as
                  stored, through the wrapper as the backward pass calls
                  it (``kernel_launch(dy, w.transpose(1, 2), ...)``,
                  ``wrapper_ms``: a transposed copy of W1 included where
                  the tree makes one) and the kernel alone (``ms``)
  prefill.counts  Arctic-480B's prefill w1 product: 128 experts, cap 40,
                  D 7,168 -> F 4,864, every expert keeping 1 to 40 rows
  decode.counts   Arctic-480B's decode step: cap 8, 8 experts keeping
                  1 to 8 rows

Weights and rows are noise from a seed, drawn on the card; DeepSeek's
kept counts are min(cap, Poisson(2,048 x 6 / 160)) a group, the
routing's mean.  Each result is held against the plain version
(``chip_smoke._k7_check``: one bf16 rounding), and unkept rows must be
exactly zero.  ``bound_ms`` counts the kept rows of x (dy), the weights
of the experts that keep rows, and the whole output, over 3.35 TB/s.
Times are medians of CUDA-event intervals (``chip_smoke.time_ms``).

It prints the card's name and power limit, then one JSON object.

Run: ``python3 tools/k7_probe.py [--src SRC_DIR] [--reps N]`` (one card).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, E, cap, D, F): D -> F is the product's depth -> width
ROWS = [("deepseek", 160, 96, 5120, 1536), ("backward", 160, 96, 5120, 1536),
        ("prefill.counts", 128, 40, 7168, 4864),
        ("decode.counts", 128, 8, 7168, 4864)]
DEEPSEEK_ASSIGNMENTS = 2048 * 6  # 4 x 512 tokens, top-6


def _counts(np, rng, name, E, cap):
    if name in ("deepseek", "backward"):
        return np.minimum(rng.poisson(DEEPSEEK_ASSIGNMENTS / E, E), cap)
    if name == "prefill.counts":
        return rng.integers(1, cap + 1, E)
    counts = np.zeros(E, np.int64)
    counts[rng.choice(E, 8, replace=False)] = rng.integers(1, cap + 1, 8)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src/ first on the path

    sys.path.insert(0, os.path.abspath(args.src))  # ahead of it
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import grouped_matmul as k7

    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    gen = torch.Generator(device=dev)
    res = {"src": os.path.abspath(args.src),
           "in_place_dx": hasattr(k7, "b_storage")}
    for name, E, cap, D, F in ROWS:
        gen.manual_seed(cs.SEED)
        w = (torch.randn((E, D, F), generator=gen, device=dev)
             * D ** -0.5).to(torch.bfloat16)
        counts = _counts(np, rng, name, E, cap)
        gs = torch.from_numpy(counts.astype(np.int32)).to(dev)
        T = E * cap
        kept = torch.zeros(T, dtype=torch.bool)
        for g in np.nonzero(counts)[0]:
            kept[g * cap:g * cap + int(counts[g])] = True
        kept = kept.to(dev)
        if name == "backward":  # dx (E cap, D) = dy (E cap, F) W^T
            x = torch.randn((T, F), generator=gen, device=dev).to(w.dtype)
            wv = w.transpose(1, 2)
            K, N = F, D
            if res["in_place_dx"]:
                storage, k_major = k7.b_storage(wv)
                kw = dict(k_major=k_major)
            else:  # the parent's wrapper copies W^T contiguous first
                storage, kw = wv.contiguous(), {}

            def wrapper():
                return k7.kernel_launch(x, wv, gs, cap, "backward")

            def bmm():
                return torch.bmm(x.view(E, cap, F), wv)
        else:
            x = torch.randn((T, D), generator=gen, device=dev).to(w.dtype)
            wv, storage, kw, K, N = w, w, {}, D, F

            def wrapper():
                return k7.grouped_matmul(x, w, gs, cap=cap)

            def bmm():
                return torch.bmm(x.view(E, cap, D), w)

        got = wrapper()
        if not bool((got[~kept] == 0).all()):
            raise AssertionError(f"K7 {name}: unkept rows are not zero")
        want = k7.grouped_matmul_plain(x, wv, gs, cap=cap)
        err = cs._k7_check(torch, f"K7 {name}", got, want)
        out = torch.empty_like(got)
        n_kept, n_experts = int(kept.sum()), int((counts > 0).sum())
        b, by = cs.bound_ms(2 * (n_kept * K + n_experts * K * N + T * N)
                            + 4 * E, 2 * n_kept * K * N, cs.BF16_OPS_PER_S)
        res[name] = dict(
            ms=cs.time_ms(torch, lambda: k7.launch(x, storage, gs, out,
                                                   cap=cap, **kw),
                          reps=args.reps),
            wrapper_ms=cs.time_ms(torch, wrapper, reps=args.reps),
            bmm_ms=cs.time_ms(torch, bmm, reps=args.reps),
            bound_ms=b, bound_by=by, max_abs_err=err,
            shape=f"E={E} cap={cap} K={K} N={N}, {n_experts} experts keep "
                  f"{n_kept} rows, bf16")
        cs.log(f"k7_probe: {name} {res[name]}")
        del w, wv, storage, x, got, want, out
        torch.cuda.empty_cache()
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
