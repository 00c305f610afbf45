"""Key-value stream API over the zipper kernels (device tier).

Port of the device tier of ``repro.core.stream``.  A *stream* is a
sequence of (key, value) tuples — in SpGEMM, the expanded partial
products of one output row.  SparseZipper processes R-wide chunks of up
to S streams in lock step; these functions keep the whole lock-step
merge tree on the device and return the instruction counters as device
tensors, so ``SpzStats`` stays exact without a host round trip per
bucket.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend as kb
from repro_torch.kernels import ops
from repro_torch.kernels.chunk_sort import chunk_lens


def merge_partitions(ka, va, la, kb_, vb, lb, *, R=16, pair_streams=None,
                     with_counters=True, backend="auto"):
    """Full merge of two padded (N, L) partitions per stream with the
    lock-step chunk advancement.  Returns (keys, vals, lens,
    MergeCounters)."""
    return ops.merge_partitions(ka, va, la, kb_, vb, lb, R=R,
                                pair_streams=pair_streams,
                                with_counters=with_counters, backend=backend)


def chunk_sort_partitions(keys, vals, plens, *, R, backend="auto"):
    """Chunk-sort (S, L) padded streams into (S, C, R) sorted partitions.

    All S*C R-chunks are sorted in one call of the backend's
    ``chunk_sort``; the counters keep the host accounting (one mssort per
    chunk column that holds any data, ceil(max plens / R) issues).

    Returns (keys (S, C, R), vals, lens (S, C), n_mssort, sort_elems)."""
    S, L = keys.shape
    C = L // R
    if C * R != L:
        raise ValueError(f"partition width {L} must be a multiple of R={R}")
    bk = kb.resolve_backend(backend, keys.device)
    sk, sv, sl = bk.chunk_sort(keys.reshape(S * C, R), vals.reshape(S * C, R),
                               chunk_lens(plens, C, R))
    plens = plens.long()
    n_mssort = (plens.max() + R - 1) // R if S else plens.sum()
    return (sk.reshape(S, C, R), sv.reshape(S, C, R), sl.reshape(S, C),
            n_mssort, plens.sum())


def fused_sort_merge(keys, vals, plens, *, R, backend="auto",
                     with_counters=True, detailed=False):
    """Sort + zip-merge tree over padded product streams: the seam that
    runs the backend's ``fused_bucket`` (the K3 kernel on ``cuda``, the
    plain composition on ``torch``).

    keys/vals: (S, L) unsorted partial products (EMPTY padded), L = C*R
    with C a power of two; plens: (S,) valid lengths.  Returns (keys
    (S, L), vals, lens (S,), counters (6,): [n_mssort, sort_elems,
    n_mszip, zip_elems, chunk_loads, chunk_stores]), or with
    ``detailed=True`` the per-(round, pair) merge counters of
    ``merge_tree.zip_merge_tree(detailed=True)`` in place of the
    6-vector."""
    bk = kb.resolve_backend(backend, keys.device)
    return bk.fused_bucket(keys, vals, plens.to(torch.int32), R=R,
                           with_counters=with_counters, detailed=detailed)
