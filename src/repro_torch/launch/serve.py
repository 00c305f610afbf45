"""Serving launcher: batched requests against a ported architecture.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --requests 4 --prompt-len 512 --new-tokens 32 --max-seq 1024

Random weights from a seeded generator (no checkpoint is loaded).  A
model with cross attention (whisper-small, llama-3.2-vision-11b) gets
stub frontend embeddings: float32 standard normal (requests,
num_frontend_tokens, d_model), drawn after the prompts from the same
generator, as the reference's CLI draws them.  Runs
on the card by default; ``--device cpu`` runs on the CPU (pair it with
``--smoke`` there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (cb.get_smoke_config(args.arch) if args.smoke
           else cb.get_config(args.arch))
    device = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    eng = Engine(cfg, params, max_batch=args.requests, max_seq=args.max_seq,
                 device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]
    enc = None
    if cfg.num_frontend_tokens:
        enc = rng.standard_normal(
            (args.requests, cfg.num_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    t0 = time.time()
    reqs = eng.generate(reqs, enc_inp=enc)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: {r.out[:8].tolist()}...")
    print(f"{total_tokens} tokens in {dt:.2f}s on {device} "
          f"({total_tokens / dt:.1f} tok/s incl. the first call's set-up)")


if __name__ == "__main__":
    main()
