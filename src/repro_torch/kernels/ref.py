"""Plain-torch oracles of the host tier's stream instructions.

Port of ``repro.kernels.ref`` (its SpGEMM half), bit for bit on the same
inputs:

``stream_sort_ref``  == mssortk.tt + mssortv.tt
    Sort each stream's key chunk ascending, sum the values of duplicate
    keys, compress the run totals to the front.  Returns output lengths
    (the OC counter registers).

``stream_merge_ref`` == mszipk.tt + mszipv.tt
    Two-way merge of two sorted, duplicate-free chunks per stream.  Keys
    greater than every key on the other side are withheld (the merge bit
    is never set for them); the per-side consumed counts (the IC counter
    registers) tell the driver how far each input advanced.  The merged
    chunk of up to 2R tuples is split into a low and a high half.

A duplicate run is summed from zero left to right in sorted order, one
add per element (``0 + v0 + v1 + ...``), the order in which the
reference's ``segment_sum`` adds on the CPU; the sort is stable, as
``jnp.argsort`` is.  bfloat16 values are summed in float32 and rounded
once.  These are the plain versions of the K4 and K5 kernels
(``stream_sort.py``, ``stream_merge.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.merge_tree import EMPTY


def _mask_chunk(keys, vals, lens):
    """Invalidate positions >= lens (per stream)."""
    r = torch.arange(keys.shape[-1], device=keys.device)
    valid = r[None, :] < lens.long()[:, None]
    return (torch.where(valid, keys, EMPTY).to(torch.int32),
            torch.where(valid, vals, 0.0))


def run_sums(v, first):
    """In-order running sums of the runs of each row of ``v`` (S, W),
    a run starting where ``first`` is set: each element holds its run's
    sum from zero up to it (``0 + v0 + ... + vi``), so a run's total sits
    on its last element.  One add per element, left to right, on any
    device; the loop stops at the longest run (one host read)."""
    r = torch.arange(v.shape[-1], device=v.device)
    start = torch.cummax(torch.where(first, r, 0), dim=-1).values
    run_pos = r - start
    acc = v + 0.0
    zero_col = torch.zeros_like(acc[:, :1])
    for d in range(1, int(run_pos.max()) + 1 if run_pos.numel() else 1):
        shifted = torch.cat([zero_col, acc[:, :-1]], dim=-1)
        acc = torch.where(run_pos == d, shifted + v, acc)
    return acc


def _sort_combine_compress(keys, vals):
    """Sort by key, sum duplicate runs, compress.

    keys: (S, W) int32 (EMPTY = invalid), vals: (S, W) float.
    Returns (keys, vals, out_lens (S,) int32) with the uniques packed at
    the front, values in ``vals.dtype``."""
    k, order = torch.sort(keys, dim=-1, stable=True)
    v = torch.gather(vals.float(), -1, order)
    empty_col = torch.full_like(k[:, :1], EMPTY)
    prev = torch.cat([empty_col, k[:, :-1]], dim=-1)
    acc = run_sums(v, k != prev)
    nxt = torch.cat([k[:, 1:], empty_col], dim=-1)
    is_last = (k != nxt) & (k != EMPTY)
    # compress: a stable re-sort sends EMPTY to the back, keeps uniques
    # in order
    k2 = torch.where(is_last, k, EMPTY)
    k3, order2 = torch.sort(k2, dim=-1, stable=True)
    v3 = torch.gather(torch.where(is_last, acc, 0.0), -1, order2)
    out_lens = (k3 != EMPTY).sum(-1, dtype=torch.int32)
    return k3, v3.to(vals.dtype), out_lens


def stream_sort_ref(keys, vals, lens):
    """Sort + combine + compress key-value chunks across S streams.

    keys: (S, R) int32, vals: (S, R) float32 or bfloat16, lens: (S,).
    Returns (out_keys (S, R) int32, out_vals (S, R), out_lens (S,) int32)."""
    return _sort_combine_compress(*_mask_chunk(keys, vals, lens))


def stream_merge_ref(ka, va, la, kb, vb, lb):
    """Merge two sorted duplicate-free chunks per stream.

    Returns (k_lo, v_lo, k_hi, v_hi, consumed_a, consumed_b, out_lens):
    (k_lo | k_hi) is the packed sorted merged output of length
    out_lens <= 2R, consumed_* the per-side advanced counts (int32)."""
    R = ka.shape[-1]
    ka_m, va_m = _mask_chunk(ka, va, la)
    kb_m, vb_m = _mask_chunk(kb, vb, lb)
    # max valid key per side; -1 when the side is empty
    max_a = torch.where(ka_m != EMPTY, ka_m, -1).amax(-1)
    max_b = torch.where(kb_m != EMPTY, kb_m, -1).amax(-1)
    cutoff = torch.minimum(max_a, max_b)  # unmergeable beyond this
    merge_a = (ka_m != EMPTY) & (ka_m <= cutoff[:, None])
    merge_b = (kb_m != EMPTY) & (kb_m <= cutoff[:, None])
    consumed_a = merge_a.sum(-1, dtype=torch.int32)
    consumed_b = merge_b.sum(-1, dtype=torch.int32)
    cat_k = torch.cat([torch.where(merge_a, ka_m, EMPTY),
                       torch.where(merge_b, kb_m, EMPTY)], dim=-1)
    cat_v = torch.cat([torch.where(merge_a, va_m, 0.0),
                       torch.where(merge_b, vb_m, 0.0)], dim=-1)
    k, v, out_lens = _sort_combine_compress(cat_k.to(torch.int32), cat_v)
    return (k[:, :R], v[:, :R], k[:, R:], v[:, R:], consumed_a, consumed_b,
            out_lens)
