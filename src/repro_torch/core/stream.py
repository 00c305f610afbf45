"""Key-value stream API over the zipper kernels.

Port of ``repro.core.stream``.  A *stream* is a sequence of (key, value)
tuples — in SpGEMM, the expanded partial products of one output row.
SparseZipper processes R-wide chunks of up to S streams in lock step.
Two tiers:

  * the **host tier** (``sort_chunks``/``merge_chunks`` plus the numpy
    helpers ``gather_chunk_fronts``/``scatter_chunk_outputs``, the
    mlxe.t / msxe.t analogues) issues one (S, R) kernel at a time — the
    spz host driver's per-instruction path;
  * the **device tier** (``merge_partitions``, ``chunk_sort_partitions``,
    ``fused_sort_merge``) keeps the whole lock-step merge tree on the
    device and returns the instruction counters as device tensors, so
    ``SpzStats`` stays exact without a host round trip per bucket.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import backend as kb
from repro_torch.kernels import ops
from repro_torch.kernels.chunk_sort import chunk_lens
from repro_torch.kernels.merge_tree import EMPTY


def sort_chunks(keys, vals, lens, *, backend="auto", cap_s=None):
    """mssortk+mssortv over S lock-step streams: one (S, R) front."""
    return ops.stream_sort(keys, vals, lens, backend=backend, cap_s=cap_s)


def merge_chunks(ka, va, la, kb_, vb, lb, *, backend="auto", cap_s=None):
    """mszipk+mszipv over S lock-step streams: two (S, R) fronts."""
    return ops.stream_merge(ka, va, la, kb_, vb, lb, backend=backend,
                            cap_s=cap_s)


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


def gather_chunk_fronts(parts_k, parts_v, ptrs, R):
    """Build an (S, R) chunk front from ragged numpy partitions.

    parts_k/parts_v: per-stream numpy arrays; ptrs: per-stream read
    offsets.  Returns (keys, vals, lens) numpy arrays — the mlxe.t
    analogue."""
    S = len(parts_k)
    keys = np.full((S, R), EMPTY, np.int32)
    vals = np.zeros((S, R), np.float32)
    lens = np.zeros(S, np.int32)
    for s in range(S):
        k = parts_k[s]
        p = int(ptrs[s])
        n = min(R, len(k) - p)
        if n > 0:
            keys[s, :n] = k[p:p + n]
            vals[s, :n] = parts_v[s][p:p + n]
            lens[s] = n
    return keys, vals, lens


def scatter_chunk_outputs(out_k, out_v, dst_k, dst_v, dst_ptrs, out_lens):
    """Append per-stream valid outputs to destination buffers — the msxe.t
    analogue.  out_k/out_v: (S, W) numpy; dst_*: per-stream numpy
    buffers; dst_ptrs advance by out_lens."""
    for s in range(len(dst_k)):
        n = int(out_lens[s])
        if n > 0:
            p = int(dst_ptrs[s])
            dst_k[s][p:p + n] = out_k[s, :n]
            dst_v[s][p:p + n] = out_v[s, :n]
            dst_ptrs[s] = p + n
