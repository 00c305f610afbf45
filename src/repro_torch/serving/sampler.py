"""Samplers over a batch of logits (B, V), and the zipper top-k merge.

Port of ``repro.serving.sampler``: ``greedy`` and ``topk_sample``, the
latter with an explicit ``torch.Generator``, and ``zipper_topk``: with
the vocab sharded over the model axis, the global top-k is the merge of
the shards' sorted candidate streams, the paper's mszip use case.  Each
pairwise merge goes through ``kernels.ops.stream_merge``: K5
(``csrc/stream_merge.cu``) on the card, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.merge_tree import EMPTY


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


def zipper_topk(logits_shards, k, *, device=None):
    """Global top-k over per-shard logits via the stream-merge primitive.

    logits_shards: a list of (V_loc,) logits, one per model shard, numpy
    arrays or torch tensors; the merges run where torch shards lie, or
    on ``device`` for numpy shards (default: the card).  Returns
    (values, global ids int64) of the global top-k, descending, on that
    device.

    As the reference: keys must ascend for the zipper, so each shard's
    local top-k is keyed by its quantized distance below the global max
    (one quantization for all shards, so keys compare across them), with
    the shard id in the low bits to keep keys unique (the zipper adds
    the values of equal keys, which would corrupt the carried ids); the
    values carry the global vocab ids.  The sorted streams merge
    pairwise, each merge a chunked mszip loop of R-wide chunks (R the
    power of two >= k)."""
    if torch.is_tensor(logits_shards[0]):
        dev = logits_shards[0].device
    else:
        dev = resolve_device(device)
    shards = [torch.as_tensor(np.asarray(s) if not torch.is_tensor(s) else s)
              .to(dev) for s in logits_shards]
    R = 1 << max(0, k - 1).bit_length()
    n_sh = len(shards)
    gmax = float(torch.stack([s.max().double() for s in shards]).max())
    parts = []
    for s, lg in enumerate(shards):
        val, loc = torch.topk(lg, min(k, lg.shape[0]))   # local top-k, desc
        q = torch.round((gmax - val.double()) * 1e6)
        q = (q.clamp(0, 2**26).long() * n_sh + s).to(torch.int32)
        q, order = torch.sort(q, stable=True)
        parts.append((q, (loc[order] + s * lg.shape[0]).to(torch.float32)))
    while len(parts) > 1:
        nxt = [_merge_two(*parts[i], *parts[i + 1], R)
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    take = parts[0][1][:k].long()
    return torch.cat(shards)[take], take


def _merge_two(ka, va, kb, vb, R):
    """Chunked mszip merge of two sorted (key, id) streams: one
    ``stream_merge`` (S = 1) per step over the next R of each side, the
    merged uniques kept and each side advanced by its consumed count (one
    host read a step); the rest of either side follows (keys are unique,
    so nothing accumulates)."""
    out_k, out_v = [], []
    pa = pb = 0
    while pa < len(ka) and pb < len(kb):
        ca, cav, la = _chunk(ka, va, pa, R)
        cb, cbv, lb = _chunk(kb, vb, pb, R)
        klo, vlo, khi, vhi, na, nb, ol = kops.stream_merge(
            ca, cav, la, cb, cbv, lb)
        n, na, nb = torch.cat([ol, na, nb]).tolist()
        out_k.append(torch.cat([klo[0], khi[0]])[:n])
        out_v.append(torch.cat([vlo[0], vhi[0]])[:n])
        pa += na
        pb += nb
    out_k += [ka[pa:], kb[pb:]]
    out_v += [va[pa:], vb[pb:]]
    return torch.cat(out_k), torch.cat(out_v)


def _chunk(k, v, p, R):
    """The (1, R) chunk of stream (k, v) from position ``p``, EMPTY
    padded, and its length (1,)."""
    n = min(R, len(k) - p)
    ck = torch.full((1, R), EMPTY, dtype=torch.int32, device=k.device)
    cv = torch.zeros((1, R), dtype=torch.float32, device=k.device)
    ck[0, :n] = k[p:p + n]
    cv[0, :n] = v[p:p + n]
    return ck, cv, torch.full((1,), n, dtype=torch.int32, device=k.device)
