"""K3, the fused bucket: CUDA kernel wrappers and their plain versions.

Port of the Pallas kernel ``repro.kernels.fused_bucket.fused_bucket_pallas``
and of the jitted program around it, ``repro.core.spgemm._fused_bucket_impl``
(expansion + the kernel): chunk-sort every R-chunk of an (S, L = C * R)
work bucket and fold the C sorted partitions of each stream through the
log2(C)-round zip-merge tree, with the SparseZipper counters.

The kernel (``csrc/fused_bucket.cu``) has two entries, one body:

:func:`fused_expand_bucket`
    the spz driver's bucket: the expansion of ``row_ids`` / ``lane_ids``
    from the six stacked CSR arrays is the kernel's load stage, and the
    per-(round, pair) counters are reduced on the card into a lock-step
    group's accumulators (:func:`accumulators`), so a bucket is one
    launch;
:func:`fused_bucket`
    padded (S, L) keys / values and their lengths, the contract of
    ``fused_bucket_pallas`` and of ``core.stream.fused_sort_merge``.

Both take the kernel while :func:`fused_config` gives it a launch shape,
up to L = 8,192; a wider bucket (the ``large`` route) runs K1
(``chunk_sort``) once and one K2 launch (``merge_pairs``) per round on the
stacked partition pairs, as ``zip_merge_tree`` stacks them.

``fused_bucket.launches`` counts launches of K3 itself;
``fused_bucket.routes`` counts buckets by route: ``expand`` and
``fused`` (the two entries on the kernel), ``large``.  The plain
versions are the oracle compositions; the wrappers take them only for
CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.chunk_sort import chunk_lens, chunk_sort
from repro_torch.kernels.merge_partitions import merge_pairs
from repro_torch.kernels.merge_tree import (EMPTY, sort_chunks_linear,
                                            zip_merge_tree)

# threads one block may have
MAX_THREADS = 1024


def fused_config(L: int, R: int):
    """K3's launch shape for streams of width L = C * R: (slots a thread,
    streams a block, threads a block), or None for a bucket on the large
    route.  A thread owns min(8, 2R, max(1, L / 256)) consecutive slots
    (never more than a first-round merge pair holds), a stream L / that
    many threads, and a block as many streams as make one warp."""
    items = min(8, 2 * R, max(1, L // 256))
    tps = L // items
    if tps > MAX_THREADS:
        return None
    spb = max(1, 32 // tps)
    return items, spb, spb * tps


def accumulators(Cg: int, device):
    """A lock-step group's merge counters, zeroed in one fill, for a group
    whose widest bucket has Cg chunks: round k, pair q at column
    Cg - (Cg >> k) + q.  Returns (buffer, steps (W,), zips (W,) by round,
    tails (W, 2)) int64, W = max(Cg - 1, 1), the three views of one
    buffer; ``buffer.view(4, W).sum(1)`` is [n_mszip, zip_elems, tail
    stores in two parts]."""
    W = max(Cg - 1, 1)
    return _views(torch.zeros(4 * W, dtype=torch.int64, device=device))


def _views(buf):
    W = buf.numel() // 4
    return buf, buf[:W], buf[W:2 * W], buf[2 * W:].view(W, 2)


def reduce_rounds(rounds, steps_acc, zip_acc, tails_acc) -> None:
    """Fold one bucket's per-(round, pair) counters into its group's
    accumulators (:func:`accumulators`), in place: a pair's steps and
    tails by max over buckets, zip elements summed per round."""
    Cg = steps_acc.numel() + 1
    for k, (steps, ze, tails) in enumerate(rounds):
        c0, P = Cg - (Cg >> k), steps.numel()
        steps_acc[c0:c0 + P] = torch.maximum(steps_acc[c0:c0 + P], steps)
        tails_acc[c0:c0 + P] = torch.maximum(tails_acc[c0:c0 + P], tails)
        zip_acc[k] += ze


# ---------------------------------------------------------------------------
# the expansion, plain (the expand entry's load stage)
# ---------------------------------------------------------------------------

def expand_geometry(a_indptr, a_idx, b_indptr):
    """Per-lane cumulated work of the A entries, flattened onto one
    monotone axis (lane l at offset l * (max total work + 1)) so one
    searchsorted serves the whole batch.  Returns (wcum0 (Bn, nnz_cap+1),
    wflat, offs (Bn,)), all int64."""
    Bn = a_indptr.shape[0]
    nnz_cap = a_idx.shape[1]
    dev = a_idx.device
    blen = b_indptr[:, 1:] - b_indptr[:, :-1]
    nnz = a_indptr[:, -1].long()
    t_ok = torch.arange(nnz_cap, device=dev)[None, :] < nnz[:, None]
    j_all = torch.where(t_ok, a_idx, 0).long()
    w = torch.where(t_ok, torch.gather(blen, 1, j_all), 0)
    wcum0 = torch.cat([torch.zeros((Bn, 1), dtype=torch.int64, device=dev),
                       torch.cumsum(w, dim=1, dtype=torch.int64)], dim=1)
    M = wcum0[:, -1].max() + 1
    offs = torch.arange(Bn, dtype=torch.int64, device=dev) * M
    return wcum0, (wcum0 + offs[:, None]).reshape(-1), offs


def fused_expand_plain(row_ids, lane_ids, a_indptr, a_idx, a_val,
                       b_indptr, b_idx, b_val, L: int, geometry=None):
    """Device-side expansion: per-stream padded partial products.

    row_ids/lane_ids: (S,) — stream s expands output row ``row_ids[s]``
    of batch lane ``lane_ids[s]`` (row_ids < 0 marks padding streams).
    Matrix arrays are (batch, ...) stacked.  ``geometry``: the
    :func:`expand_geometry` of these matrices, when the caller has it.
    Returns (keys (S, L) int32, vals (S, L) float32, plens (S,) int32)
    with EMPTY/0 padding."""
    Bn, n_rows1 = a_indptr.shape
    nnz_cap = a_idx.shape[1]
    bcap = b_idx.shape[1]
    dev = a_idx.device
    wcum0, wflat, offs = geometry or expand_geometry(a_indptr, a_idx,
                                                     b_indptr)
    valid_s = row_ids >= 0
    lane = lane_ids.long().clamp(0, Bn - 1)
    row = row_ids.long().clamp(0, n_rows1 - 2)
    t0 = a_indptr[lane, row].long()
    t1 = a_indptr[lane, row + 1].long()
    ws = wcum0[lane, t0]
    we = torch.where(valid_s, wcum0[lane, t1], ws)
    plens = we - ws
    p = torch.arange(L, dtype=torch.int64, device=dev)
    pvalid = p[None, :] < plens[:, None]
    g = torch.where(pvalid, ws[:, None] + p[None, :], ws[:, None])
    q = (g + offs[lane][:, None]).reshape(-1)
    # product g belongs to the last A-entry whose cumulated work <= g
    tg = torch.searchsorted(wflat, q, right=True).reshape(g.shape) - 1
    t = (tg - (lane * (nnz_cap + 1))[:, None]).clamp(0, nnz_cap - 1)
    base = wflat[tg] - offs[lane][:, None]
    lane2 = lane[:, None]
    # a padding entry's column is EMPTY: clamp it (its product is masked)
    j = a_idx[lane2, t].long().clamp(0, b_indptr.shape[1] - 1)
    pos = (b_indptr[lane2, j] + (g - base)).clamp(0, bcap - 1)
    keys = torch.where(pvalid, b_idx[lane2, pos], EMPTY)
    vals = torch.where(pvalid, a_val[lane2, t] * b_val[lane2, pos], 0.0)
    return keys.to(torch.int32), vals, plens.to(torch.int32)


# ---------------------------------------------------------------------------
# the streams entry
# ---------------------------------------------------------------------------

def _counters(plens, rounds, R: int, with_counters: bool):
    """The host driver's 6-vector [n_mssort, sort_elems, n_mszip,
    zip_elems, chunk_loads, chunk_stores] from per-round counters."""
    plens = plens.long()
    zero = torch.zeros((), dtype=torch.int64, device=plens.device)
    n_mssort = (plens.max() + R - 1) // R if plens.numel() else zero
    sort_elems = plens.sum()
    n_zip = zip_elems = tail_sum = zero
    if with_counters:
        for steps, ze, tails in rounds:
            n_zip = n_zip + steps.sum()
            zip_elems = zip_elems + ze
            tail_sum = tail_sum + tails.sum()
    return torch.stack([n_mssort, sort_elems, n_zip, zip_elems,
                        n_mssort + 2 * n_zip, n_mssort + n_zip + tail_sum])


def fused_bucket_plain(keys, vals, plens, *, R: int,
                       with_counters: bool = True, detailed: bool = False,
                       chunk_sort=sort_chunks_linear):
    """Plain torch: ``chunk_sort`` (default ``sort_chunks_linear``; the
    ``ref`` tier's ``ref.stream_sort_ref``) over all chunks, then
    ``zip_merge_tree``.  Same contract as :func:`fused_bucket`."""
    S, L = keys.shape
    C = L // R
    sk, sv, sl = chunk_sort(keys.reshape(S * C, R),
                                    vals.reshape(S * C, R),
                                    chunk_lens(plens, C, R))
    mk, mv, ml, rounds = zip_merge_tree(
        sk.reshape(S, C, R), sv.reshape(S, C, R), sl.reshape(S, C), R=R,
        with_counters=False, detailed=with_counters or detailed)
    if detailed:
        return mk, mv, ml, rounds
    return mk, mv, ml, _counters(plens, rounds, R, with_counters)


def launch(keys, vals, plens, R: int, ok, ov, ol, acc) -> None:
    """Launch K3's streams entry on checked, contiguous CUDA tensors
    (outputs allocated by the caller; ``acc`` the buffer of
    :func:`accumulators` for Cg = C) on the current stream; raise on a
    launch error."""
    lib = _build.LIBS.get("fused_bucket")
    S, L = keys.shape
    items, spb, threads = fused_config(L, R)
    _, steps, zips, tails = _views(acc)
    err = lib.zipper_fused_bucket(
        keys.data_ptr(), vals.data_ptr(), plens.data_ptr(), S, L, R, items,
        spb, threads, ok.data_ptr(), ov.data_ptr(), ol.data_ptr(),
        steps.data_ptr(), tails.data_ptr(), zips.data_ptr(),
        steps.numel() + 1, stream_of(keys))
    _build.check(lib, err, "fused_bucket")


def _fused_route(keys, vals, plens, R: int):
    S, L = keys.shape
    C = L // R
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    ol = torch.empty_like(plens)
    acc, steps, zips, tails = accumulators(C, keys.device)
    launch(keys, vals, plens, R, ok, ov, ol, acc)
    fused_bucket.launches += 1
    rounds = []
    for k in range(C.bit_length() - 1):
        c0 = C - (C >> k)
        cols = slice(c0, c0 + (C >> (k + 1)))
        rounds.append((steps[cols], zips[k], tails[cols]))
    return ok, ov, ol, rounds


def _large_route(keys, vals, plens, R: int, with_counters: bool):
    S, L = keys.shape
    C = L // R
    sk, sv, sl = chunk_sort(keys.view(S * C, R), vals.view(S * C, R),
                            chunk_lens(plens, C, R))
    # partitions (S, cur_c, W); each round stacks pair q's streams as
    # rows [q*S, (q+1)*S), the layout zip_merge_tree merges
    k, v, n = sk.view(S, C, R), sv.view(S, C, R), sl.view(S, C)
    rounds = []
    W, cur_c = R, C
    while cur_c > 1:
        half = cur_c // 2

        def side(t, first):
            return t[:, first::2].transpose(0, 1).reshape(half * S, *t.shape[2:])

        ko, vo, lo, steps, ze, tails = merge_pairs(
            side(k, 0), side(v, 0), side(n, 0), side(k, 1), side(v, 1),
            side(n, 1), R=R, pair_streams=S, with_counters=with_counters)
        rounds.append((steps, ze, tails))
        k = ko.view(half, S, 2 * W).transpose(0, 1)
        v = vo.view(half, S, 2 * W).transpose(0, 1)
        n = lo.view(half, S).transpose(0, 1)
        W, cur_c = 2 * W, half
    return (k.reshape(S, L), v.reshape(S, L), n.reshape(S).contiguous(),
            rounds)


def _check_shape(S: int, L: int, R: int) -> None:
    C = L // R if R else 0
    if R <= 0 or R & (R - 1) or C <= 0 or C & (C - 1) or C * R != L \
            or S == 0:
        raise ValueError(f"bucket ({S}, {L}) needs S > 0 and L = C * R with "
                         f"R={R} and C powers of two")


def fused_bucket(keys, vals, plens, *, R: int, with_counters: bool = True,
                 detailed: bool = False):
    """Sort + full zip-merge tree over one (S, L, R) work bucket — the
    contract of ``core.stream.fused_sort_merge``.

    keys/vals: (S, L) int32/float32 unsorted padded product streams,
    L = C * R with R and C powers of two; plens: (S,) valid lengths.
    Returns (keys (S, L), vals, lens (S,) int32, counters (6,) int64:
    [n_mssort, sort_elems, n_mszip, zip_elems, chunk_loads,
    chunk_stores]), or with ``detailed=True`` the per-round
    (steps (P,), zip_elems (), tails (P, 2)) tuples of
    ``zip_merge_tree(detailed=True)`` in place of the 6-vector."""
    if keys.device.type == "cpu":
        return fused_bucket_plain(keys, vals, plens, R=R,
                                  with_counters=with_counters,
                                  detailed=detailed)
    S, L = keys.shape
    _check_shape(S, L, R)
    keys, vals, plens = cuda_inputs((keys, torch.int32), (vals, torch.float32),
                                    (plens.to(torch.int32), torch.int32))
    if fused_config(L, R) is not None:
        fused_bucket.routes["fused"] += 1
        mk, mv, ml, rounds = _fused_route(keys, vals, plens, R)
    else:
        fused_bucket.routes["large"] += 1
        mk, mv, ml, rounds = _large_route(keys, vals, plens, R,
                                          with_counters or detailed)
    if detailed:
        return mk, mv, ml, tuple(rounds)
    return mk, mv, ml, _counters(plens, rounds, R, with_counters)


fused_bucket.launches = 0
fused_bucket.routes = {"expand": 0, "fused": 0, "large": 0}


# ---------------------------------------------------------------------------
# the expand entry
# ---------------------------------------------------------------------------

def fused_expand_bucket_plain(row_ids, lane_ids, a_indptr, a_idx, a_val,
                              b_indptr, b_idx, b_val, *, R: int, L: int,
                              steps_acc, zip_acc, tails_acc,
                              chunk_sort=sort_chunks_linear):
    """Plain torch: :func:`fused_expand_plain`, :func:`fused_bucket_plain`
    (with ``chunk_sort``) and :func:`reduce_rounds`.  Same contract as
    :func:`fused_expand_bucket`."""
    keys, vals, plens = fused_expand_plain(row_ids, lane_ids, a_indptr,
                                           a_idx, a_val, b_indptr, b_idx,
                                           b_val, L)
    mk, mv, ml, rounds = fused_bucket_plain(keys, vals, plens, R=R,
                                            detailed=True,
                                            chunk_sort=chunk_sort)
    reduce_rounds(rounds, steps_acc, zip_acc, tails_acc)
    return mk, mv, ml


def launch_expand(row_ids, lane_ids, mats, R: int, L: int, ok, ov, ol,
                  steps_acc, zip_acc, tails_acc) -> None:
    """Launch K3's expand entry on checked, contiguous CUDA tensors
    (``mats`` the six stacked CSR arrays; outputs and accumulators
    allocated by the caller) on the current stream; raise on a launch
    error."""
    lib = _build.LIBS.get("fused_bucket")
    a_indptr, a_idx, a_val, b_indptr, b_idx, b_val = mats
    items, spb, threads = fused_config(L, R)
    err = lib.zipper_fused_expand(
        row_ids.data_ptr(), lane_ids.data_ptr(), row_ids.numel(),
        a_indptr.data_ptr(), a_idx.data_ptr(), a_val.data_ptr(),
        b_indptr.data_ptr(), b_idx.data_ptr(), b_val.data_ptr(),
        a_indptr.shape[0], a_indptr.shape[1], a_idx.shape[1],
        b_indptr.shape[1], b_idx.shape[1], L, R, items, spb, threads,
        ok.data_ptr(), ov.data_ptr(), ol.data_ptr(), steps_acc.data_ptr(),
        tails_acc.data_ptr(), zip_acc.data_ptr(), steps_acc.numel() + 1,
        stream_of(row_ids))
    _build.check(lib, err, "fused_bucket")


def fused_expand_bucket(row_ids, lane_ids, a_indptr, a_idx, a_val,
                        b_indptr, b_idx, b_val, *, R: int, L: int,
                        steps_acc, zip_acc, tails_acc):
    """One work bucket of a lock-step group, expansion to merged streams:
    the port's form of the reference's jitted ``_fused_bucket_impl``.

    row_ids/lane_ids: (S,) int64 — stream s expands output row
    ``row_ids[s]`` of batch lane ``lane_ids[s]`` (row_ids < 0: padding);
    the six (batch, ...) stacked CSR arrays as ``fused_expand_plain``
    takes them; L = C * R with R and C powers of two, at least every
    stream's product count, on the kernel's route (:func:`fused_config`).
    The bucket's per-(round, pair) counters are folded into its group's
    accumulators (:func:`accumulators`: steps and tails by max, zip
    elements summed per round), in place.
    Returns (keys (S, L) int32, vals (S, L) float32, lens (S,) int32)."""
    if row_ids.device.type == "cpu":
        return fused_expand_bucket_plain(
            row_ids, lane_ids, a_indptr, a_idx, a_val, b_indptr, b_idx,
            b_val, R=R, L=L, steps_acc=steps_acc, zip_acc=zip_acc,
            tails_acc=tails_acc)
    S = row_ids.numel()
    _check_shape(S, L, R)
    if fused_config(L, R) is None:
        raise ValueError(f"bucket width L={L} at R={R} is on the large "
                         f"route; the expand entry takes L <= "
                         f"{MAX_THREADS * min(8, 2 * R)}")
    Cg = steps_acc.numel() + 1
    for acc, shape in ((steps_acc, (Cg - 1,)), (zip_acc, (Cg - 1,)),
                       (tails_acc, (Cg - 1, 2))):
        if acc.dtype != torch.int64 or not acc.is_contiguous() \
                or acc.device != row_ids.device \
                or tuple(acc.shape) != shape:
            raise ValueError("accumulators must be contiguous int64 "
                             f"{shape} tensors on {row_ids.device}")
    if L // R > Cg:
        raise ValueError(f"accumulators for {Cg} chunks cannot take a "
                         f"bucket of {L // R}")
    row_ids, lane_ids, *mats = cuda_inputs(
        (row_ids, torch.int64), (lane_ids, torch.int64),
        (a_indptr, torch.int32), (a_idx, torch.int32),
        (a_val, torch.float32), (b_indptr, torch.int32),
        (b_idx, torch.int32), (b_val, torch.float32))
    dev = row_ids.device
    ok = torch.empty((S, L), dtype=torch.int32, device=dev)
    ov = torch.empty((S, L), dtype=torch.float32, device=dev)
    ol = torch.empty(S, dtype=torch.int32, device=dev)
    launch_expand(row_ids, lane_ids, mats, R, L, ok, ov, ol, steps_acc,
                  zip_acc, tails_acc)
    fused_bucket.launches += 1
    fused_bucket.routes["expand"] += 1
    return ok, ov, ol
