"""Plain-torch zip-merge tree: the oracle tier of the stream primitives.

Port of ``repro.kernels.merge_tree`` (the JAX package's XLA oracle),
bit-exact on the same inputs, counters included.  Every function here is
plain tensor code that runs on the CPU or the card; the CUDA kernels in
``chunk_sort.py``, ``merge_partitions.py`` and ``fused_bucket.py`` are
held against these functions.

``merge_partitions``
    Fully merge two padded (N, L) sorted-unique partitions per stream.
    The payload is the rank-based union merge (row-wise searchsorted +
    gathers); the SparseZipper instruction counters come from the
    per-stream chunk-advancement state machine (``_advance_counters``).

``zip_merge_tree``
    The full tree over C = 2**k sorted R-chunk partitions: each round
    stacks all partition pairs onto the stream axis and merges them with
    one ``merge_partitions``-style call.

``sort_chunks_linear``
    The chunk sort: stable sort on (key, source lane), an R-step
    sequential run prefix (left-to-right float association, the same
    adds in the same order as the reference), and a searchsorted
    compaction.

Invariants (shared with the kernels): merge inputs are per-row ascending
and duplicate-free, EMPTY-padded past their ``lens``; R is a power of
two; a cross-side duplicate accumulates as the single add ``va + vb``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# Sentinel key (INT32_MAX): pads every row past its valid length and sorts
# after every valid key.  Defined here, the lowest layer that needs it, so
# the kernel modules import without the core package.
EMPTY = 2**31 - 1

# The advancement loop tests its exit condition (a host sync) once per
# this many steps; the extra steps of a finished loop are exact no-ops
# (inactive streams present empty fronts and count nothing).
_STEPS_PER_SYNC = 16


class MergeCounters(NamedTuple):
    """SparseZipper dynamic-instruction counters, as 0-dim int64 tensors."""

    n_mszip: torch.Tensor      # zip-instruction issues
    zip_elems: torch.Tensor    # key-value tuples moved through merge
    chunk_loads: torch.Tensor  # mlxe.t analogue (chunk fronts built)
    chunk_stores: torch.Tensor # msxe.t analogue


def _arange(n, like):
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _searchsorted(a, q, right=False):
    """Per-row searchsorted: a (N, W) sorted rows, q (N, Q) queries."""
    return torch.searchsorted(a.contiguous(), q.contiguous(), right=right)


def _cross(k_own, ok_own, k_other, l_other):
    """Rank of each own key in the other side (left searchsorted over the
    padded row) and whether the other side holds the same key."""
    N, W = k_own.shape
    Wo = k_other.shape[1]
    if Wo == 0:
        z = torch.zeros((N, W), dtype=torch.int64, device=k_own.device)
        return z, torch.zeros((N, W), dtype=torch.bool, device=k_own.device), z
    j = _searchsorted(k_other, k_own)
    j_c = j.clamp(max=Wo - 1)
    match = ok_own & (j < l_other[:, None]) & \
        (torch.gather(k_other, 1, j_c) == k_own)
    return j, match, j_c


def _union_merge(ka, va, la, kb, vb, lb):
    """One-shot merge of two sorted duplicate-free padded partitions.

    Equal keys across sides accumulate as ``va + vb``; all other values
    pass through untouched.  Returns (keys (N, La+Lb), vals, lens)."""
    N, La = ka.shape
    Lb = kb.shape[1]
    Lo = La + Lb
    la = la.long()
    lb = lb.long()
    ar = _arange(La, ka)
    br = _arange(Lb, ka)
    a_ok = ar[None, :] < la[:, None]
    b_ok = br[None, :] < lb[:, None]
    jb, amatch, jb_c = _cross(ka, a_ok, kb, lb)
    ia, bmatch, ia_c = _cross(kb, b_ok, ka, la)
    # a absorbs its duplicate's value; dropped b keeps the a slot position
    va2 = torch.where(amatch, va + torch.gather(vb, 1, jb_c), va) if Lb else va
    excl_a = torch.cumsum(amatch, 1) - amatch.long()
    excl_b = torch.cumsum(bmatch, 1) - bmatch.long()
    # output rank: position among the merged uniques
    pos_a = torch.where(a_ok, ar[None, :] + jb - excl_a, Lo)
    pos_b_surv = br[None, :] + ia - excl_b
    if La:
        pos_b_surv = torch.where(bmatch, torch.gather(pos_a, 1, ia_c),
                                 pos_b_surv)
    pos_b = torch.where(b_ok, pos_b_surv, Lo)
    # invert the (strictly increasing over valid slots) rank maps with
    # searchsorted: a gather-only compaction
    m = _arange(Lo, ka)[None, :].expand(N, Lo)
    out_k = torch.full((N, Lo), EMPTY, dtype=torch.int32, device=ka.device)
    out_v = torch.zeros((N, Lo), dtype=va.dtype, device=ka.device)
    is_a = torch.zeros((N, Lo), dtype=torch.bool, device=ka.device)
    if La:
        qa = _searchsorted(pos_a, m)
        qa_c = qa.clamp(max=La - 1)
        is_a = (qa < La) & (torch.gather(pos_a, 1, qa_c) == m)
        out_k = torch.where(is_a, torch.gather(ka, 1, qa_c), out_k)
        out_v = torch.where(is_a, torch.gather(va2, 1, qa_c), out_v)
    if Lb:
        qb = _searchsorted(pos_b, m)
        qb_c = qb.clamp(max=Lb - 1)
        is_b = ~is_a & (qb < Lb) & (torch.gather(pos_b, 1, qb_c) == m)
        out_k = torch.where(is_b, torch.gather(kb, 1, qb_c), out_k)
        out_v = torch.where(is_b, torch.gather(vb, 1, qb_c), out_v)
    out_len = (la + lb - amatch.sum(1)).to(torch.int32)
    return out_k, out_v, out_len


def sort_chunks_linear(keys, vals, lens):
    """Chunk sort/combine/compress of (N, R) chunks, bit-identical to the
    reference ``sort_chunks_linear``: stable sort (ties keep product
    order), an R-step sequential run prefix so duplicate values add left
    to right, and a searchsorted compaction of each run's total.

    Returns (keys (N, R) int32, vals (N, R), lens (N,) int32)."""
    N, R = keys.shape
    r = _arange(R, keys)
    in_ok = r[None, :] < lens.long()[:, None]
    k0 = torch.where(in_ok, keys, EMPTY).to(torch.int32)
    v0 = torch.where(in_ok, vals, 0.0)
    k, order = torch.sort(k0, dim=-1, stable=True)
    v = torch.gather(v0, -1, order)
    empty_col = torch.full_like(k[:, :1], EMPTY)
    prev = torch.cat([empty_col, k[:, :-1]], dim=-1)
    start = k != prev
    start_idx = torch.cummax(torch.where(start, r[None, :], 0), dim=1).values
    run_pos = r[None, :] - start_idx
    acc = v
    zero_col = torch.zeros_like(acc[:, :1])
    for d in range(1, R):
        shifted = torch.cat([zero_col, acc[:, :-1]], dim=-1)
        acc = torch.where(run_pos == d, shifted + v, acc)
    nxt = torch.cat([k[:, 1:], empty_col], dim=-1)
    is_last = (k != nxt) & (k != EMPTY)
    csum = torch.cumsum(is_last, dim=-1)
    idx = _searchsorted(csum, (r[None, :] + 1).expand(N, R))
    idx_c = idx.clamp(max=R - 1)
    n = csum[:, -1:] if R else torch.zeros((N, 1), dtype=torch.int64,
                                           device=keys.device)
    out_ok = r[None, :] < n
    out_k = torch.where(out_ok, torch.gather(k, -1, idx_c), EMPTY)
    out_v = torch.where(out_ok, torch.gather(acc, -1, idx_c), 0.0)
    return out_k.to(torch.int32), out_v, n[:, 0].to(torch.int32)


def _front_keys(K, lens, ptr, R: int):
    """(N, R) key chunk front at ``ptr`` (EMPTY past the effective lens)."""
    N, L = K.shape
    n = (lens - ptr).clamp(0, R)
    ok = _arange(R, K)[None, :] < n[:, None]
    if L == 0:
        return torch.full((N, R), EMPTY, dtype=K.dtype, device=K.device), n
    idx = (ptr[:, None] + _arange(R, K)[None, :]).clamp(0, L - 1)
    return torch.where(ok, torch.gather(K, 1, idx), EMPTY), n


def _advance_counters(ka, la, kb, lb, *, R: int, pair_streams: int):
    """Run the lock-step chunk-advancement state machine on pointers only.

    Per-stream read pointers pa/pb advance by the mszip consumed counts
    (all keys <= the merge-bit cutoff) until one side of every stream is
    exhausted.  Returns (steps (P,), zip_elems (), tails (P, 2)) as int64:
    per-pair issue counts, total tuples presented, and per-pair/per-side
    copy-through tail stores."""
    N = ka.shape[0]
    S = pair_streams
    P = N // S
    la = la.long()
    lb = lb.long()
    pa = torch.zeros(N, dtype=torch.int64, device=ka.device)
    pb = torch.zeros_like(pa)
    steps = torch.zeros(P, dtype=torch.int64, device=ka.device)
    zip_elems = torch.zeros((), dtype=torch.int64, device=ka.device)
    while bool(((pa < la) & (pb < lb)).any()):
        for _ in range(_STEPS_PER_SYNC):
            both = (pa < la) & (pb < lb)
            fa_k, fa_n = _front_keys(ka, torch.where(both, la, 0), pa, R)
            fb_k, fb_n = _front_keys(kb, torch.where(both, lb, 0), pb, R)
            # merge-bit cutoff: max valid key per side (-1 when empty)
            max_a = torch.where(fa_k != EMPTY, fa_k, -1).amax(1)
            max_b = torch.where(fb_k != EMPTY, fb_k, -1).amax(1)
            cutoff = torch.minimum(max_a, max_b)[:, None]
            ca = ((fa_k != EMPTY) & (fa_k <= cutoff)).sum(1)
            cb = ((fb_k != EMPTY) & (fb_k <= cutoff)).sum(1)
            steps += both.reshape(P, S).any(1)
            zip_elems += (fa_n + fb_n).sum()
            pa = pa + ca
            pb = pb + cb
    # copy-through tail stores (one msxe.t per R-chunk, lock-step per pair)
    tails = []
    for lens, ptr in ((la, pa), (lb, pb)):
        rem = (lens - ptr).clamp(min=0)
        tails.append(((rem + R - 1) // R).reshape(P, S).amax(1))
    return steps, zip_elems, torch.stack(tails, dim=1)


def _round_counters(steps, zip_elems, tails) -> MergeCounters:
    n_zip = steps.sum()
    return MergeCounters(n_zip, zip_elems, 2 * n_zip, n_zip + tails.sum())


def zero_counters(device) -> MergeCounters:
    z = torch.zeros((), dtype=torch.int64, device=device)
    return MergeCounters(z, z, z, z)


def merge_partitions(ka, va, la, kb, vb, lb, *, R: int,
                     pair_streams: int | None = None,
                     with_counters: bool = True):
    """Fully merge two padded sorted-unique partitions per stream.

    ka/kb: (N, La)/(N, Lb) int32 keys (EMPTY padded); va/vb: float32
    values; la/lb: (N,) valid lengths.  R: chunk width of the modelled
    mszip issue.  ``pair_streams``: lock-step group size S — rows
    [p*S, (p+1)*S) form partition pair p, and a zip issue is counted per
    pair per advancement step while that pair is active.  Default: all N
    rows are one pair.  ``with_counters=False`` skips the state machine
    and returns zero counters.

    Returns (keys (N, La+Lb), vals, lens (N,) int32, MergeCounters)."""
    N = ka.shape[0]
    S = pair_streams or N
    if N % max(S, 1):
        raise ValueError(f"pair_streams {S} must divide stream count {N}")
    ko, vo, lo = _union_merge(ka, va, la, kb, vb, lb)
    if with_counters and N:
        cnt = _round_counters(*_advance_counters(ka, la, kb, lb, R=R,
                                                 pair_streams=S))
    else:
        cnt = zero_counters(ka.device)
    return ko, vo, lo, cnt


def zip_merge_tree(keys, vals, lens, *, R: int, with_counters: bool = True,
                   detailed: bool = False):
    """Zip-merge tree over C = 2**k sorted R-chunk partitions.

    keys/vals: (S, C, R) sorted-unique partitions (trailing partitions may
    be empty — they merge as no-ops and cost no zip issues); lens: (S, C).

    Returns (keys (S, C*R), vals, lens (S,), counters) where counters is
    a MergeCounters of summed scalars, or — with ``detailed=True`` — a
    tuple with one (steps (P,), zip_elems (), tails (P, 2)) entry per
    round."""
    S, C, _ = keys.shape
    if C & (C - 1):
        raise ValueError(f"partition count {C} must be a power of two")
    parts = [(keys[:, c], vals[:, c], lens[:, c].to(torch.int32))
             for c in range(C)]
    rounds = []
    cnt = zero_counters(keys.device)
    while len(parts) > 1:
        half = len(parts) // 2
        ka, va, la = (torch.cat([parts[2 * j][i] for j in range(half)])
                      for i in range(3))
        kb, vb, lb = (torch.cat([parts[2 * j + 1][i] for j in range(half)])
                      for i in range(3))
        ko, vo, lo = _union_merge(ka, va, la, kb, vb, lb)
        if (with_counters or detailed) and S:
            rnd = _advance_counters(ka, la, kb, lb, R=R, pair_streams=S)
            rounds.append(rnd)
            cnt = MergeCounters(*(a + b for a, b in
                                  zip(cnt, _round_counters(*rnd))))
        parts = [(ko[j * S:(j + 1) * S], vo[j * S:(j + 1) * S],
                  lo[j * S:(j + 1) * S]) for j in range(half)]
    k, v, ln = parts[0]
    return k, v, ln, (tuple(rounds) if detailed else cnt)
