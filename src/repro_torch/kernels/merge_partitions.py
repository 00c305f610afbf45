"""K2, the partition merge: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel
``repro.kernels.merge_partitions.merge_partitions_pallas``: the full merge
of two sorted, duplicate-free, EMPTY-padded partitions per stream (a key
on both sides becomes the single add ``va + vb``) and the per-stream
chunk-advancement state machine behind the mszip counters.  The kernel
is ``csrc/merge_partitions.cu``; its plain version is the oracle
``merge_tree.merge_partitions``, bit-identical to it, counters included.

The kernel reports per-stream (steps, zip elements, tail chunks per
side); the wrapper reduces them per pair of ``pair_streams`` rows with a
few torch ops, as the Pallas wrapper does: a pair's issue count is the
max over its streams, zip elements a sum, tails the max per side.  Rows
of more than 4,096 slots take the long-row route: each row's merged
elements are cut into tiles of 2,048 over many CTAs, and its counters
come from pointer jumping over the candidate cutoffs; the wrapper
allocates that route's zeroed scratch (tile status) and tables, and
counts one launch per call.
:func:`merge_partitions` takes the plain version only for CPU tensors;
on CUDA tensors it launches the kernel (``merge_partitions.launches``)
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.merge_tree import (MergeCounters, merge_partitions
                                            as merge_partitions_plain,
                                            zero_counters)


def launch(ka, va, la, kb, vb, lb, R: int, with_counters: bool, ok, ov, ol,
           cnt) -> None:
    """Launch K2 on checked, contiguous CUDA tensors (outputs allocated by
    the caller; ``cnt`` the (4, N) int32 per-stream counters, zeroed) on
    the current stream; raise on a launch error."""
    lib = _build.LIBS.get("merge_partitions")
    N, La = ka.shape
    Lb = kb.shape[1]
    # long rows (La + Lb > 4,096) spread over many CTAs: their tiles'
    # look-back status and the pointer-jumping tables of the counters
    dev = ka.device
    words = lib.zipper_merge_scratch_words(N, La, Lb, R, int(with_counters))
    scratch = torch.zeros(words, dtype=torch.int32, device=dev) \
        if words else None
    tw = lib.zipper_merge_table_words(N, La, Lb, int(with_counters))
    tables = torch.empty(tw, dtype=torch.int32, device=dev) if tw else None
    err = lib.zipper_merge_partitions(
        ka.data_ptr(), va.data_ptr(), la.data_ptr(), kb.data_ptr(),
        vb.data_ptr(), lb.data_ptr(), N, La, Lb, R,
        int(with_counters), ok.data_ptr(), ov.data_ptr(), ol.data_ptr(),
        cnt[0].data_ptr(), cnt[1].data_ptr(), cnt[2].data_ptr(),
        cnt[3].data_ptr(), scratch.data_ptr() if words else None,
        tables.data_ptr() if tw else None, stream_of(ka))
    _build.check(lib, err, "merge_partitions")


def merge_pairs(ka, va, la, kb, vb, lb, *, R: int, pair_streams: int,
                with_counters: bool = True):
    """Launch K2 on CUDA tensors and reduce its counters per pair.

    Returns (keys (N, La+Lb), vals, lens (N,) int32, steps (P,),
    zip_elems (), tails (P, 2)) with P = N // pair_streams — one round
    of ``merge_tree.zip_merge_tree(detailed=True)``."""
    N, La = ka.shape
    Lb = kb.shape[1]
    S = pair_streams
    if N % S:
        raise ValueError(f"pair_streams {S} must divide stream count {N}")
    if va.shape != ka.shape or vb.shape != kb.shape or kb.shape[0] != N \
            or la.shape != (N,) or lb.shape != (N,):
        raise ValueError("merge_partitions takes (N, La)/(N, Lb) keys and "
                         "values with (N,) lengths")
    ka, va, la, kb, vb, lb = cuda_inputs(
        (ka, torch.int32), (va, torch.float32), (la, torch.int32),
        (kb, torch.int32), (vb, torch.float32), (lb, torch.int32))
    dev = ka.device
    # the kernel writes every output slot (merged keys, then EMPTY / 0)
    ok = torch.empty((N, La + Lb), dtype=torch.int32, device=dev)
    ov = torch.empty((N, La + Lb), dtype=torch.float32, device=dev)
    ol = torch.zeros(N, dtype=torch.int32, device=dev)
    cnt = torch.zeros((4, N), dtype=torch.int32, device=dev)
    if N and La + Lb:
        launch(ka, va, la, kb, vb, lb, R, with_counters, ok, ov, ol, cnt)
        merge_partitions.launches += 1
    per_pair = cnt.long().reshape(4, N // S, S)
    steps = per_pair[0].amax(1)
    tails = torch.stack([per_pair[2].amax(1), per_pair[3].amax(1)], dim=1)
    return ok, ov, ol, steps, cnt[1].long().sum(), tails


def merge_partitions(ka, va, la, kb, vb, lb, *, R: int,
                     pair_streams: int | None = None,
                     with_counters: bool = True):
    """Fully merge two padded sorted-unique partitions per stream — the
    contract of ``merge_tree.merge_partitions``: ka/kb (N, La)/(N, Lb)
    int32 keys, va/vb float32 values, la/lb (N,) lengths; rows
    [p*S, (p+1)*S) form pair p for the counters (S = ``pair_streams``,
    default N).  Returns (keys (N, La+Lb), vals, lens, MergeCounters)."""
    if ka.device.type == "cpu":
        return merge_partitions_plain(ka, va, la, kb, vb, lb, R=R,
                                      pair_streams=pair_streams,
                                      with_counters=with_counters)
    ko, vo, lo, steps, zip_elems, tails = merge_pairs(
        ka, va, la.to(torch.int32), kb, vb, lb.to(torch.int32), R=R,
        pair_streams=pair_streams or max(ka.shape[0], 1),
        with_counters=with_counters)
    if not with_counters:
        return ko, vo, lo, zero_counters(ka.device)
    n_zip = steps.sum()
    return ko, vo, lo, MergeCounters(n_zip, zip_elems, 2 * n_zip,
                                     n_zip + tails.sum())


merge_partitions.launches = 0
