"""Plain-torch oracles of the host tier's stream instructions and of
flash attention.

Port of ``repro.kernels.ref``.  The SpGEMM half is bit for bit on the
same inputs:

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

``stream_merge_ptr_ref``
    One issue of the host driver's merge round in pointer form: the
    fronts gathered at the pointers (``take_chunk``, the mlxe.t
    analogue), ``stream_merge_ref``, the merged rows appended at the
    output pointers (``put_rows``, msxe.t), and the pointer, zip-element
    and flag updates, in place.

A duplicate run is summed from zero left to right in sorted order, one
add per element (``0 + v0 + v1 + ...``), the order in which the
reference's ``segment_sum`` adds on the CPU; the sort is stable, as
``jnp.argsort`` is.  bfloat16 values are summed in float32 and rounded
once.  These are the plain versions of the K4 and K5 kernels
(``stream_sort.py``, ``stream_merge.py``).

``flash_attention_ref`` is the plain version of K6
(``flash_attention.py``): the function the reference's Pallas kernel
``_fa_kernel`` computes, softmax over whole rows in float32.
``mha_ref`` is the reference's own attention oracle, bf16 einsums and
all.  ``grouped_matmul_ref`` is the plain version of K7
(``grouped_matmul.py``), float32 products rounded once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.merge_tree import EMPTY

NEG_INF = -1e30


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


def take_chunk(K, V, lens, ptr, R):
    """Chunk front: slots [ptr, min(ptr + R, lens)) of each stream, with
    gathers (no wait for the card).  K/V: (S, L) padded; returns (keys
    (S, R) int32, vals (S, R), n (S,) int32)."""
    L = K.shape[1]
    idx = ptr[:, None] + torch.arange(R, device=K.device)
    ok = idx < lens[:, None]
    idx_c = idx.clamp(max=L - 1)
    keys = torch.where(ok, torch.gather(K, 1, idx_c), EMPTY)
    vals = torch.where(ok, torch.gather(V, 1, idx_c), 0.0)
    return keys, vals, ok.sum(1, dtype=torch.int32)


def put_rows(K, V, optr, src_k, src_v, n):
    """Append: write src[s, :n[s]] at K[s, optr[s]:...] with one scatter
    per array (no wait for the card).  K/V are (S, L + 1): the masked
    lanes all land in the spill column L, which the caller drops."""
    W = src_k.shape[1]
    spill = K.shape[1] - 1
    j = torch.arange(W, device=K.device)
    idx = torch.where(j[None, :] < n[:, None], optr[:, None] + j, spill)
    K.scatter_(1, idx, src_k)
    V.scatter_(1, idx, src_v)


def stream_merge_ptr_ref(Ka, Va, lens_a, Kb, Vb, lens_b, pa, pb, optr, Ko,
                         Vo, zips, flag, worked, *, R: int):
    """One mszip issue of a merge round, on pointers, in place.

    Ka/Va (S, La) and Kb/Vb (S, Lb) padded partitions with int64 lengths
    (S,); pa, pb, optr, zips (S,) int64; Ko/Vo (S, Lo + 1), the last
    column a spill column the caller drops; flag a one-element int32
    tensor; worked a one-element int64 tensor.  A stream takes part when pa < lens_a and pb < lens_b (else
    its fronts are empty): its fronts at (pa, pb) are merged by
    ``stream_merge_ref``, the merged uniques appended at optr, pa, pb and
    optr advanced, and the front sizes added to zips.  flag gets bit 0
    when a stream took part and bit 1 when one still can after the
    issue, and worked one when a stream took part.  Nothing is read back
    to the host."""
    both = (pa < lens_a) & (pb < lens_b)
    ka, va, la = take_chunk(Ka, Va, torch.where(both, lens_a, 0), pa, R)
    kb, vb, lb = take_chunk(Kb, Vb, torch.where(both, lens_b, 0), pb, R)
    klo, vlo, khi, vhi, ca, cb, ol = stream_merge_ref(ka, va, la, kb, vb, lb)
    put_rows(Ko, Vo, optr, torch.cat([klo, khi], 1),
             torch.cat([vlo, vhi], 1), ol)
    optr += ol
    pa += ca
    pb += cb
    zips += la
    zips += lb
    more = (pa < lens_a) & (pb < lens_b)
    flag.bitwise_or_((both.any().int() + 2 * more.any().int()).reshape(1))
    worked += both.any()


def _attention_mask(Sq, Skv, causal, window, device):
    """(Sq, Skv) validity of each (query, key) pair; query i sits at
    position i + Skv - Sq."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = kpos < Skv
    if causal:
        mask = mask & (qpos >= kpos)
    if window:
        mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """GQA attention as the flash-attention kernel computes it.

    q: (B, Sq, H, hd); k/v: (B, Skv, KVH, hd); query head h reads KV head
    h // (H // KVH).  q, k and v are upcast to float32; scores are
    scaled by ``scale`` (default hd ** -0.5); masked scores are set to
    NEG_INF = -1e30; softmax and the PV product are in float32, the
    denominator floored at 1e-30; the result is rounded to q.dtype once.
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(B, Sq, KVH, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    mask = _attention_mask(Sq, Skv, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def mha_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Sk, KVH, D).  GQA by head broadcast;
    both einsums in the inputs' dtype, the softmax in float32."""
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _attention_mask(Sq, k.shape[1], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# grouped (per-expert) matmul oracle
# ---------------------------------------------------------------------------

def grouped_matmul_ref(x, w, group_sizes, *, cap=None):
    """x: (T, D) rows grouped by expert; w: (E, D, F).  Contiguous layout
    (``cap`` None): group g owns rows [cum[g] - group_sizes[g], cum[g]),
    and rows at or past the last group are zero.  Counts layout: group g
    owns rows [g cap, g cap + min(group_sizes[g], cap)), and every other
    row is zero.  Returns (T, F) in x's dtype.

    The plain version of K7 (``grouped_matmul.py``): a loop over the
    groups, ``x[s:e].float() @ w[g].float()`` rounded once to x's dtype.
    In the counts layout a group that holds rows multiplies all its cap
    rows with the others zeroed (they are never read), so its kept rows
    come out bit for bit as the contiguous layout gives them over the
    zero-padded buffer.  It reads the sizes to the host and never builds
    the reference's ``w[gid]``, a (T, D, F) tensor."""
    T, F = x.shape[0], w.shape[2]
    out = torch.zeros((T, F), dtype=x.dtype, device=x.device)
    if cap is not None:
        for g, n in enumerate(group_sizes.tolist()):
            s, e, n = g * cap, min((g + 1) * cap, T), min(max(n, 0), cap)
            if n and e > s:
                xg = torch.zeros((e - s, x.shape[1]), device=x.device)
                xg[:n] = x[s:s + n].float()
                out[s:e] = (xg @ w[g].float()).to(x.dtype)
        return out
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        end = min(start + max(n, 0), T)
        if end > start:
            out[start:end] = (x[start:end].float() @ w[g].float()).to(x.dtype)
        start = end
    return out
