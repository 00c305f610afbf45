#!/usr/bin/env python3
"""How far apart bf16 runs of one model lie at full depth, on one card.

RecurrentGemma-9B at full width (38 layers, random weights from
``chip_smoke.SEED``) takes the prefill of ``chip_smoke.py``'s phase
``families`` (prompts of 2,560, 2,300, 2,100 and 1,800 tokens, left
padded) five ways:

  pallas         K6 (bf16, wgmma route), the served path
  xla            the plain blocked attention, bf16
  xla_blocks512  the same with query blocks of 1,024 and key blocks of
                 512: only the summation order differs
  xla_f32        the plain blocked attention, float32 compute
  pallas_f32     K6 (float32, fma route)

and prints the largest |difference| of the last-token logits of every
pair and whether their greedy tokens agree: the bf16 spread that
``chip_smoke.BF16_SPREAD`` is set against.  Then the card's name and
power limit.

Run: ``python3 tools/logit_spread_probe.py`` (one card, ~1 min).
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

VARIANTS = {
    "pallas": {},
    "xla": dict(attn_impl="xla"),
    "xla_blocks512": dict(attn_impl="xla", attn_q_block=1024,
                          attn_kv_block=512),
    "xla_f32": dict(attn_impl="xla", dtype="float32"),
    "pallas_f32": dict(dtype="float32"),
}


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.configs import base as cb
    from repro_torch.models import model as M

    if not torch.cuda.is_available():
        print("logit_spread_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cb.get_config("recurrentgemma-9b"),
                              attn_impl="pallas")
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    toks = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in cs.RG9B_PROMPTS]
    batch = cs._left_padded(torch, np, toks, "cuda")
    lg = {}
    for name, overrides in VARIANTS.items():
        c = dataclasses.replace(cfg, **overrides)
        lg[name] = M.prefill(params, c, batch, M.init_cache(
            c, len(toks), cs.RG9B_MAX_SEQ, "cuda"))[0].float().cpu()
        torch.cuda.empty_cache()
        print(f"{name}: largest |logit| {float(lg[name].abs().max())}")
    names = list(lg)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            same = int((lg[a].argmax(-1) == lg[b].argmax(-1)).sum())
            print(f"{a} vs {b}: max abs {float((lg[a] - lg[b]).abs().max())}"
                  f"; greedy tokens equal {same} of {len(toks)}")
    print(cs.smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
