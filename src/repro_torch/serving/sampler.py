"""Samplers over a batch of logits (B, V).

Port of ``repro.serving.sampler``: ``greedy`` and ``topk_sample``, the
latter with an explicit ``torch.Generator``.  ``zipper_topk`` (the
global top-k through the K5 stream merge) waits for a later slice.
"""
from __future__ import annotations

import torch


def greedy(logits):
    """The index of each row's largest logit (the first on a tie)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def topk_sample(logits, k=40, temperature=1.0, *, generator=None):
    """Sample each row from its ``k`` largest logits over
    ``temperature``."""
    v, idx = torch.topk(logits, k, dim=-1)
    v = v.float() / max(temperature, 1e-6)
    choice = torch.multinomial(torch.softmax(v, dim=-1), 1,
                               generator=generator)
    return torch.gather(idx, -1, choice)[..., 0].to(torch.int32)
