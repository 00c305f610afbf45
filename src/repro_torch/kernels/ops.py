"""Public wrappers over the zipper kernels, routed through the
kernel-backend registry (``kernels/backend.py``).

``backend`` below is a registered backend name (``"torch"``, ``"cuda"``),
``"auto"`` (cuda for CUDA tensors, torch elsewhere), or a resolved
:class:`~repro_torch.kernels.backend.KernelBackend`.  Unknown names raise
``ValueError`` listing the registered backends.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend as kb
from repro_torch.kernels.merge_tree import EMPTY


def _pad_streams(cap_s, keys, vals, lens):
    """Pad the stream axis up to a fixed capacity ``cap_s``.

    Batched drivers issue many chunk kernels whose stream count S varies
    (ragged tail groups); padding every issue to one (cap_s, R) shape keeps
    the launch shapes few.  Returns (keys, vals, lens, S) with S the
    stream count before padding."""
    S = keys.shape[0]
    if cap_s is None or cap_s <= S:
        return keys, vals, lens, S
    pad = cap_s - S

    def grow(t, fill):
        return torch.cat([t, t.new_full((pad, *t.shape[1:]), fill)])

    return grow(keys, EMPTY), grow(vals, 0), grow(lens, 0), S


def stream_sort(keys, vals, lens, *, backend="auto", cap_s=None):
    """mssortk+mssortv: sort/combine/compress S key-value chunks.

    ``cap_s``: optional stream-count capacity; inputs with S < cap_s are
    padded up (and the outputs sliced back), as the reference pads every
    issue of a group to one shape."""
    keys, vals, lens, S = _pad_streams(cap_s, keys, vals, lens)
    bk = kb.resolve_backend(backend, keys.device)
    ok, ov, ol = bk.stream_sort(keys, vals, lens)
    return ok[:S], ov[:S], ol[:S]


def stream_merge(ka, va, la, kb_, vb, lb, *, backend="auto", cap_s=None):
    """mszipk+mszipv: merge two sorted chunks per stream.

    ``cap_s``: as in :func:`stream_sort`.  Returns (k_lo, v_lo, k_hi,
    v_hi, consumed_a, consumed_b, out_lens)."""
    ka, va, la, S = _pad_streams(cap_s, ka, va, la)
    kb_, vb, lb, _ = _pad_streams(cap_s, kb_, vb, lb)
    bk = kb.resolve_backend(backend, ka.device)
    outs = bk.stream_merge(ka, va, la, kb_, vb, lb)
    return tuple(o[:S] for o in outs)


def merge_partitions(ka, va, la, kb_, vb, lb, *, R: int = 16,
                     pair_streams: int | None = None,
                     with_counters: bool = True, backend="auto"):
    """Partition merge: the full data-dependent chunk advancement of two
    padded (N, L) sorted-unique partitions per stream.

    Returns (keys (N, La+Lb), vals, lens, MergeCounters)."""
    bk = kb.resolve_backend(backend, ka.device)
    return bk.merge_partitions(ka, va, la, kb_, vb, lb, R=R,
                               pair_streams=pair_streams,
                               with_counters=with_counters)


# K4 sorts one front of width n in one CTA's shared memory (16 bytes a
# slot): 8,192 is the widest power of two that fits in 227 KB
SORT_TOKENS_MAX_FRONT = 8192


def sort_tokens_by_key(keys, *, backend="auto"):
    """Zipper-dispatch helper used by the MoE layer: ascending argsort of a
    1-D key vector, implemented as a stream sort whose values are slot ids.

    Unlike stream_sort, duplicates are kept (each key is made unique by
    packing the slot id into the low bits), because MoE dispatch must not
    merge tokens routed to the same expert — it only needs them grouped.
    On the ``cuda`` backend a power-of-two n from 8 to
    ``SORT_TOKENS_MAX_FRONT`` (8,192) is sorted by K4 as one front of
    width n, as the reference's ``pallas`` tier does; any other n, and
    the ``torch`` backend (the MoE block's route, as the reference's
    ``xla``), take an argsort of the packed keys.
    Returns (sorted_keys, perm) such that keys[perm] == sorted_keys.
    """
    (n,) = keys.shape
    bits = max(1, (n - 1).bit_length())
    slot = torch.arange(n, dtype=torch.int32, device=keys.device)
    packed = (keys.to(torch.int32) << bits) | slot
    bk = kb.resolve_backend(backend, keys.device)
    if bk.name == "cuda" and n & (n - 1) == 0 \
            and 8 <= n <= SORT_TOKENS_MAX_FRONT:
        lens = torch.full((1,), n, dtype=torch.int32, device=keys.device)
        pk, pv, _ = bk.stream_sort(packed[None], slot.float()[None], lens)
        return pk[0] >> bits, pv[0].to(torch.int32)
    order = torch.argsort(packed)
    return keys[order], order.to(torch.int32)
