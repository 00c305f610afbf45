#!/usr/bin/env python3
"""Time K6 (flash attention) at the served prefills' shapes, on one card.

K6 (``repro_torch.kernels.flash_attention``) runs the prefill attention
of the models served with ``attn_impl="pallas"``.  This script times
its launch alone (``ms``) and through the wrapper the model calls
(``wrapper_ms``: the checks, the output's allocation, the launch), on
the tree whose ``src/`` it is given, so two trees can be compared on
one card in turns (parent, change, change, parent):

  tinyllama    TinyLlama-1.1B's prefill: B 4, S 512, 32 / 4 heads, hd 64,
               causal
  whisper_enc  Whisper-small's encoder: B 4, S 1,500, 12 / 12 heads,
               hd 64, bidirectional
  vision       Llama-3.2-Vision-11B's prefill: B 4, S 512, 32 / 8 heads,
               hd 128, causal

q, k and v are bf16 noise from a seed, drawn on the card (the wgmma
route).  Each result is held against the plain version
(``chip_smoke._k6_check``).  Times are medians of CUDA-event intervals
(``chip_smoke.time_ms``).

It prints the card's name and power limit, then one JSON object.

Run: ``python3 tools/k6_probe.py [--src SRC_DIR] [--reps N]`` (one card).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, S, H, KVH, hd, causal)
ROWS = [("tinyllama", 4, 512, 32, 4, 64, True),
        ("whisper_enc", 4, 1500, 12, 12, 64, False),
        ("vision", 4, 512, 32, 8, 128, True)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # puts this checkout's src/ first on the path

    sys.path.insert(0, os.path.abspath(args.src))  # ahead of it
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as k6

    res = {"src": os.path.abspath(args.src)}
    rng = np.random.default_rng(cs.SEED)
    for name, B, S, H, KVH, hd, causal in ROWS:
        q, k, v = cs._attn_inputs(torch, np, rng, B, S, S, H, KVH, hd,
                                  torch.bfloat16)
        got = k6.flash_attention(q, k, v, causal=causal)
        want = k6.flash_attention_plain(q, k, v, causal=causal)
        err = cs._k6_check(torch, f"K6 {name}", got, want, 3e-2)
        out = torch.empty_like(got)
        res[name] = dict(
            ms=cs.time_ms(torch, lambda: k6.launch(
                q, k, v, out, causal=causal, window=0, scale=hd ** -0.5),
                reps=args.reps, warmup=5),
            wrapper_ms=cs.time_ms(torch, lambda: k6.flash_attention(
                q, k, v, causal=causal), reps=args.reps, warmup=5),
            max_abs_err=err,
            shape=f"B={B} S={S} H={H} KVH={KVH} hd={hd} causal={causal}, "
                  f"bf16")
        cs.log(f"k6_probe: {name} {res[name]}")
    print(cs.smi())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
