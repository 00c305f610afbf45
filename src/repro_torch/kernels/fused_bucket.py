"""K3, the fused bucket: CUDA kernel wrapper and its plain version.

Port of the Pallas kernel ``repro.kernels.fused_bucket.fused_bucket_pallas``:
chunk-sort every R-chunk of an (S, L = C * R) work bucket and fold the C
sorted partitions of each stream through the log2(C)-round zip-merge
tree, returning the merged streams and the SparseZipper counters.

Two routes, both hand-written kernels, chosen per bucket by its shared
memory need (``csrc/fused_bucket.cu`` computes it):

``fused``
    one launch of K3 (``csrc/fused_bucket.cu``) with the partitions in
    shared memory; taken while one block's streams fit the 232,448 B a
    block may use, i.e. up to L = 8192;
``large``
    K1 (``chunk_sort``) once, then one K2 launch (``merge_pairs``) per
    round on the stacked partition pairs, as ``zip_merge_tree`` stacks
    them (``pair_streams=S``); taken for L >= 16,384.

``fused_bucket.routes`` counts the buckets each route took and
``fused_bucket.launches`` the launches of K3 itself.  The plain version
is the oracle composition ``sort_chunks_linear`` + ``zip_merge_tree``;
:func:`fused_bucket` takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_inputs, stream_of
from repro_torch.kernels.chunk_sort import chunk_lens, chunk_sort
from repro_torch.kernels.merge_partitions import merge_pairs
from repro_torch.kernels.merge_tree import sort_chunks_linear, zip_merge_tree

# dynamic shared memory one block of an H100 may use
SMEM_PER_BLOCK = 232_448


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
                       with_counters: bool = True, detailed: bool = False):
    """Plain torch: ``sort_chunks_linear`` over all chunks, then
    ``zip_merge_tree``.  Same contract as :func:`fused_bucket`."""
    S, L = keys.shape
    C = L // R
    sk, sv, sl = sort_chunks_linear(keys.reshape(S * C, R),
                                    vals.reshape(S * C, R),
                                    chunk_lens(plens, C, R))
    mk, mv, ml, rounds = zip_merge_tree(
        sk.reshape(S, C, R), sv.reshape(S, C, R), sl.reshape(S, C), R=R,
        with_counters=False, detailed=with_counters or detailed)
    if detailed:
        return mk, mv, ml, rounds
    return mk, mv, ml, _counters(plens, rounds, R, with_counters)


def launch(keys, vals, plens, R: int, ok, ov, ol, planes) -> None:
    """Launch K3 on checked, contiguous CUDA tensors (outputs allocated by
    the caller; ``planes`` the (4, S, max(C-1, 1)) int32 counter planes,
    zeroed) on the current stream; raise on a launch error."""
    lib = _build.LIBS.get("fused_bucket")
    S, L = keys.shape
    err = lib.zipper_fused_bucket(
        keys.data_ptr(), vals.data_ptr(), plens.data_ptr(), S, L, R,
        ok.data_ptr(), ov.data_ptr(), ol.data_ptr(), planes[0].data_ptr(),
        planes[1].data_ptr(), planes[2].data_ptr(), planes[3].data_ptr(),
        stream_of(keys))
    _build.check(lib, err, "fused_bucket")


def _fused_route(keys, vals, plens, R: int):
    S, L = keys.shape
    C = L // R
    # the kernel writes every output element and length; the counter
    # planes only where a round exists (C == 1 keeps one zero column)
    ok = torch.empty_like(keys)
    ov = torch.empty_like(vals)
    ol = torch.empty_like(plens)
    planes = torch.zeros((4, S, max(C - 1, 1)), dtype=torch.int32,
                         device=keys.device)
    launch(keys, vals, plens, R, ok, ov, ol, planes)
    fused_bucket.launches += 1
    # round r's pairs sit at columns [C - C>>r, C - C>>(r+1)); a pair's
    # steps/tails are the max over streams, zip elements a sum
    col_max = planes.amax(1).long()
    col_zip = planes[1].sum(0, dtype=torch.int64)
    rounds = []
    col, half = 0, C // 2
    while half >= 1:
        cols = slice(col, col + half)
        rounds.append((col_max[0, cols], col_zip[cols].sum(),
                       col_max[2:, cols].t()))
        col, half = col + half, half // 2
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
    C = L // R
    if R & (R - 1) or C & (C - 1) or C * R != L or S == 0:
        raise ValueError(f"bucket ({S}, {L}) needs S > 0 and L = C * R with "
                         f"R={R} and C powers of two")
    keys, vals, plens = cuda_inputs((keys, torch.int32), (vals, torch.float32),
                                    (plens.to(torch.int32), torch.int32))
    lib = _build.LIBS.get("fused_bucket")
    if lib.zipper_fused_smem_bytes(S, L, R) <= SMEM_PER_BLOCK:
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
fused_bucket.routes = {"fused": 0, "large": 0}
