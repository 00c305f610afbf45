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
