"""Batched serving engine: static batching, one prefill, then decode.

Port of ``repro.serving.engine``.  ``generate`` pads every prompt on the
left with token 0 to the longest prompt (the padded positions are
attended, as in the reference), fills a shared KV cache with one prefill
(which also takes ``enc_inp``, the frontend's embeddings, for a model
with cross attention; decode reads their K/V from the cache)
and decodes the batch together, greedy or top-k, reading each step's
tokens to the host once.  The reference decodes once more after the
last token and drops the result; the port stops after the last token,
with the same tokens.

The engine runs on the card unless ``device`` names another; a CUDA
device without a card raises.  ``generate`` runs under
``torch.inference_mode()``.  After each ``generate`` the host-clock
times of the prefill (through its first token's host read) and of each
decode step are in ``Engine.stats``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import sampler


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    out: Optional[np.ndarray] = None


class Engine:
    def __init__(self, cfg, params: M.Model, *, max_batch=8, max_seq=256,
                 greedy=True, seed=0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats: dict = {}

    def _next(self, logits):
        if self.greedy:
            return sampler.greedy(logits)
        return sampler.topk_sample(logits, generator=self.generator)

    @torch.inference_mode()
    def generate(self, requests: List[Request],
                 enc_inp=None) -> List[Request]:
        """Static batching: pad all prompts to one length, decode
        together.  ``enc_inp`` (B, num_frontend_tokens, D), a numpy array
        or tensor, goes to the engine's device and into the prefill.
        Fills each request's ``out`` with its new tokens."""
        B = len(requests)
        if not 0 < B <= self.max_batch:
            raise ValueError(f"{B} requests for a batch of {self.max_batch}")
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        if plen + max_new - 1 > self.max_seq:
            raise ValueError(f"prompt {plen} + {max_new} new tokens exceed "
                             f"the cache's {self.max_seq} positions")
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        cfg, params = self.cfg, self.params
        cache = M.init_cache(cfg, B, self.max_seq, self.device,
                             enc_len=cfg.num_frontend_tokens)
        if enc_inp is not None:
            enc_inp = torch.as_tensor(enc_inp).to(self.device)
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg,
                                  torch.from_numpy(toks).to(self.device),
                                  cache, enc_inp=enc_inp)
        nxt = self._next(logits)
        host = nxt.cpu().numpy()  # the one host read per token
        self.stats = {"prefill_s": time.perf_counter() - t0, "decode_s": []}
        outs = [[] for _ in range(B)]
        for t in range(max_new):
            for i in range(B):
                if t < requests[i].max_new_tokens:
                    outs[i].append(int(host[i]))
            if t == max_new - 1:
                break
            t0 = time.perf_counter()
            logits, cache = M.decode_step(params, cfg, nxt[:, None].long(),
                                          cache, plen + t)
            nxt = self._next(logits)
            host = nxt.cpu().numpy()
            self.stats["decode_s"].append(time.perf_counter() - t0)
        for i, r in enumerate(requests):
            r.out = np.asarray(outs[i], np.int32)
        return requests
