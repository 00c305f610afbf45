"""Row-wise (Gustavson) SpGEMM engines.

Port of ``repro.core.spgemm``:

  scl-array  — scalar row loop with a dense accumulator row (the oracle;
               numpy on the host)
  scl-hash   — scalar row loop with a hash-style unique/accumulate (numpy
               on the host, the paper's scalar baseline)
  esc        — vectorized Expand-Sort-Compress (the vec-radix baseline):
               plain torch on the device, two stable sorts and an
               in-order segmented sum
  spz        — merge-based SpGEMM on the SparseZipper primitives: chunked
               stream sort + zip-merge tree with data-dependent advancement,
               lock-step groups of S streams.  Two drivers: the default
               device-resident "fused" driver (expand, then one
               ``fused_sort_merge`` per work bucket) and the paper-faithful
               "host" lock-step driver (one K4/K5 kernel issue per chunk,
               with the Fig. 9 expand/sort/output time breakdown)
  spz-rsort  — spz with rows pre-sorted by per-row work

The fused driver keeps every bucket's output and counters on the device
and reads them back once per call: the output as one COO assembly, the
counters as one small tensor.  The host driver keeps its partitions on
the device too and waits for the card once per merge issue, to decide
whether the lock-step loop goes on.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import stream as kvstream
from repro_torch.core.formats import (CSR, EMPTY, csr_from_coo, csr_to_numpy,
                                      row_ids_from_indptr)
from repro_torch.kernels import backend as kb
from repro_torch.kernels.ref import run_sums


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  A CUDA request without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


# ---------------------------------------------------------------------------
# work statistics (Table III)
# ---------------------------------------------------------------------------

def row_work(A: CSR, B: CSR) -> np.ndarray:
    """#multiplications to compute each output row (Table III 'Work')."""
    a_indptr, a_idx, _ = csr_to_numpy(A)
    b_indptr = csr_to_numpy(B)[0]
    blen = (b_indptr[1:] - b_indptr[:-1]).astype(np.int64)
    w = np.zeros(A.n_rows, np.int64)
    contrib = blen[a_idx]
    rows = np.repeat(np.arange(A.n_rows), a_indptr[1:] - a_indptr[:-1])
    np.add.at(w, rows, contrib)
    return w


def work_stats(A: CSR, B: CSR, group: int = 16) -> dict:
    """Per-row and per-group work stats (Table III reproduction)."""
    w = row_work(A, B)
    n = len(w)
    pad = (-n) % group
    wg = np.pad(w, (0, pad)).reshape(-1, group).sum(1)
    nnz = int(csr_to_numpy(A)[0][-1])
    return {
        "nnz": nnz,
        "density": float(nnz) / (A.n_rows * A.n_cols),
        "avg_work_per_row": float(w.mean()),
        "avg_work_per_group": float(wg.mean()),
        "work_var_per_group": float(wg.std() / max(wg.mean(), 1e-12)),
        "total_work": int(w.sum()),
    }


# ---------------------------------------------------------------------------
# scalar baseline (numpy, row-at-a-time — the paper's scl-array)
# ---------------------------------------------------------------------------

def spgemm_scl_array(A: CSR, B: CSR) -> CSR:
    """Dense-accumulator-row scalar SpGEMM (oracle for everything else).
    Runs on the host; returns a CPU CSR."""
    a_indptr, a_idx, a_val = csr_to_numpy(A)
    b_indptr, b_idx, b_val = csr_to_numpy(B)
    acc = np.zeros(B.n_cols, np.float64)
    out_r, out_c, out_v = [], [], []
    for i in range(A.n_rows):
        touched = []
        for t in range(a_indptr[i], a_indptr[i + 1]):
            j, av = a_idx[t], a_val[t]
            s, e = b_indptr[j], b_indptr[j + 1]
            cols = b_idx[s:e]
            acc[cols] += av * b_val[s:e]
            touched.append(cols)
        if touched:
            cols = np.unique(np.concatenate(touched))
            vals = acc[cols]
            acc[cols] = 0.0
            nz = vals != 0.0
            out_r.append(np.full(nz.sum(), i, np.int64))
            out_c.append(cols[nz])
            out_v.append(vals[nz])
    if not out_r:
        return csr_from_coo([], [], [], (A.n_rows, B.n_cols))
    return csr_from_coo(np.concatenate(out_r), np.concatenate(out_c),
                        np.concatenate(out_v), (A.n_rows, B.n_cols))


def spgemm_scl_hash(A: CSR, B: CSR, *, device=None) -> CSR:
    """Hash-accumulate scalar SpGEMM (paper's scl-hash; the per-row hash
    table is modelled by sort-unique accumulation over the expanded
    products of one row at a time).  Runs on the host with numpy and
    returns the CSR on ``device`` (default the card)."""
    device = resolve_device(device)
    a_indptr, a_idx, a_val = csr_to_numpy(A)
    b_indptr, b_idx, b_val = csr_to_numpy(B)
    out_r, out_c, out_v = [], [], []
    for i in range(A.n_rows):
        ks, vs = [], []
        for t in range(a_indptr[i], a_indptr[i + 1]):
            j, av = a_idx[t], a_val[t]
            s, e = b_indptr[j], b_indptr[j + 1]
            ks.append(b_idx[s:e])
            vs.append(av * b_val[s:e])
        if not ks:
            continue
        k = np.concatenate(ks)
        v = np.concatenate(vs)
        uk, inv = np.unique(k, return_inverse=True)
        uv = np.zeros(len(uk), np.float64)
        np.add.at(uv, inv, v)
        nz = uv != 0.0
        out_r.append(np.full(nz.sum(), i, np.int64))
        out_c.append(uk[nz])
        out_v.append(uv[nz])
    if not out_r:
        return csr_from_coo([], [], [], (A.n_rows, B.n_cols)).to(device)
    return csr_from_coo(np.concatenate(out_r), np.concatenate(out_c),
                        np.concatenate(out_v), (A.n_rows, B.n_cols)).to(device)


# ---------------------------------------------------------------------------
# ESC (vec-radix analogue): plain torch on the device
# ---------------------------------------------------------------------------

def esc_core_impl(a_indptr, a_idx, a_val, b_indptr, b_idx, b_val,
                  cap_products: int, n_rows: int, n_cols: int):
    """Expand all products, sort them by (row, col) with two stable
    sorts (the radix sort's role), sum duplicate (row, col) runs.

    Matrix arrays are one CSR's padded tensors.  Returns (out_r, out_c,
    out_v (cap_products,), valid_out, n_out) as the reference does:
    segment s of the sorted products at position s, padding rows/cols
    n_rows/n_cols."""
    dev = a_idx.device
    nnz_a_cap = a_idx.shape[0]
    # expansion: product p belongs to A-entry t = searchsorted(wcum, p)
    a_rows = row_ids_from_indptr(a_indptr, nnz_a_cap).long()
    blen = (b_indptr[1:] - b_indptr[:-1]).long()
    nnz_a = a_indptr[-1].long()
    t_valid = torch.arange(nnz_a_cap, device=dev) < nnz_a
    j_of_t = torch.where(t_valid, a_idx.long(), 0)
    w_t = torch.where(t_valid, blen[j_of_t.clamp(max=blen.shape[0] - 1)], 0)
    wcum = torch.cumsum(w_t, 0)
    total_work = wcum[-1]
    p = torch.arange(cap_products, device=dev)
    t_of_p = torch.searchsorted(wcum, p, right=True).clamp(0, nnz_a_cap - 1)
    p_valid = p < total_work
    base = torch.where(t_of_p > 0, wcum[(t_of_p - 1).clamp(min=0)], 0)
    s_of_p = b_indptr.long()[j_of_t[t_of_p]] + (p - base)
    s_of_p = s_of_p.clamp(0, b_idx.shape[0] - 1)
    prod_row = torch.where(p_valid, a_rows[t_of_p], n_rows)
    prod_col = torch.where(p_valid, b_idx.long()[s_of_p], n_cols)
    prod_val = torch.where(p_valid, a_val[t_of_p] * b_val[s_of_p], 0.0)
    # sort by (row, col): two stable passes
    c1, o1 = torch.sort(prod_col, stable=True)
    r1, v1 = prod_row[o1], prod_val[o1]
    r2, o2 = torch.sort(r1, stable=True)
    c2, v2 = c1[o2], v1[o2]
    # compress: sum duplicate (row, col) runs in order
    first = (r2 != torch.roll(r2, 1)) | (c2 != torch.roll(c2, 1))
    first[0] = True
    # padding products (row n_rows) each form a run of their own, so the
    # longest run, which bounds the summation loop, is a real one
    first |= r2 >= n_rows
    seg = torch.cumsum(first, 0) - 1
    # in order, from zero: the adds of the reference's segment_sum on the
    # CPU (index_add_ on CUDA adds in an order that changes run to run)
    acc = run_sums(v2[None], first[None])[0]
    last = torch.cat([first[1:], first.new_ones(1)])
    # each run's last element writes its segment's slot; the others go to
    # a spill slot past the end
    slot = torch.where(last, seg, cap_products)
    out_v = v2.new_zeros(cap_products + 1).scatter_(0, slot, acc)[:-1]
    out_r = torch.full((cap_products + 1,), n_rows, dtype=torch.int32,
                       device=dev).scatter_(0, slot, r2.to(torch.int32))[:-1]
    out_c = torch.full((cap_products + 1,), n_cols, dtype=torch.int32,
                       device=dev).scatter_(0, slot, c2.to(torch.int32))[:-1]
    valid_out = (out_r < n_rows) & (out_v != 0.0)
    n_out = valid_out.sum(dtype=torch.int32)
    return out_r, out_c, out_v, valid_out, n_out


def spgemm_esc(A: CSR, B: CSR, cap_products: int | None = None, *,
               device=None) -> CSR:
    """Vectorized Expand-Sort-Compress SpGEMM (the vec-radix analogue),
    on ``device`` (default the card).  Returns the CSR there."""
    device = resolve_device(device)
    if cap_products is None:
        cap_products = int(max(16, row_work(A, B).sum()))
    A, B = A.to(device), B.to(device)
    r, c, v, valid, _ = esc_core_impl(A.indptr, A.indices, A.data,
                                      B.indptr, B.indices, B.data,
                                      cap_products, A.n_rows, B.n_cols)
    # the valid slots are sorted by (row, col) and unique
    return _sorted_coo_to_csr(r[valid], c[valid], v[valid],
                              (A.n_rows, B.n_cols))


# ---------------------------------------------------------------------------
# SparseZipper merge-based SpGEMM (spz / spz-rsort)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpzStats:
    """Dynamic instruction counts (Fig. 11), traffic (Fig. 10) and the
    execution-time breakdown (Fig. 9)."""
    n_mssort: int = 0        # sort-instruction issues (S-stream lock-step)
    n_mszip: int = 0         # zip-instruction issues
    sort_elems: int = 0      # key-value tuples moved through sort
    zip_elems: int = 0       # key-value tuples moved through merge
    chunk_loads: int = 0     # mlxe.t analogue (chunk fronts built)
    chunk_stores: int = 0    # msxe.t analogue
    t_preprocess: float = 0.0  # row-work calc (+ rsort row ordering)
    t_expand: float = 0.0      # stream expansion (multiplications)
    t_sort: float = 0.0        # stream sorting + merging (host enqueue,
                               # and the host driver's per-issue waits)
    t_output: float = 0.0      # output generation, incl. the device wait


# ---------------------------------------------------------------------------
# the host (lock-step) driver: one K4/K5 issue per chunk
# ---------------------------------------------------------------------------

def expand_group(rows, a_indptr, a_idx, a_val, b_indptr, b_idx, b_val):
    """Vectorized expansion (RVV phase in the paper) for a group of rows,
    on the host.  Returns per-row (cols, vals) numpy arrays of partial
    products."""
    out = []
    for i in rows:
        s, e = a_indptr[i], a_indptr[i + 1]
        js = a_idx[s:e]
        avs = a_val[s:e]
        if len(js) == 0:
            out.append((np.empty(0, np.int32), np.empty(0, np.float32)))
            continue
        starts = b_indptr[js]
        lens = (b_indptr[js + 1] - starts).astype(np.int64)
        total = int(lens.sum())
        if total == 0:
            out.append((np.empty(0, np.int32), np.empty(0, np.float32)))
            continue
        pos = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens) \
            + np.repeat(starts, lens)
        cols = b_idx[pos].astype(np.int32)
        vals = (np.repeat(avs, lens) * b_val[pos]).astype(np.float32)
        out.append((cols, vals))
    return out


def sort_phase(products, R, S, backend, stats: SpzStats, cap_s=None,
               device="cpu"):
    """Chunk-sort every stream's products into sorted unique partitions,
    one K4 issue (``sort_chunks``) per chunk column.

    The group's products go to ``device`` in one copy, chunk-major, so
    chunk c of every stream is one contiguous (S, R) front; the chunk
    lengths come from the host's product counts.  Returns a list of
    partitions (keys (S, R), vals (S, R), lens (S,), live (S,) host bool:
    lens > 0), as device tensors — no wait for the card."""
    plens = np.array([len(k) for k, _ in products], np.int64)
    max_len = int(plens.max()) if S else 0
    n_chunks = -(-max_len // R)
    if not n_chunks:
        return []
    K = np.full((S, n_chunks * R), EMPTY, np.int32)
    V = np.zeros((S, n_chunks * R), np.float32)
    for s, (k, v) in enumerate(products):
        K[s, :len(k)] = k
        V[s, :len(k)] = v
    lens = np.clip(plens[None, :] - R * np.arange(n_chunks)[:, None], 0,
                   R).astype(np.int32)

    def chunk_major(a):
        return a.reshape(S, n_chunks, R).transpose(1, 0, 2).reshape(-1)

    n = n_chunks * S * R
    buf = _to_device(np.concatenate([chunk_major(K),
                                     chunk_major(V.view(np.int32)),
                                     lens.reshape(-1)]), device)
    keys = buf[:n].view(n_chunks, S, R)
    vals = buf[n:2 * n].view(torch.float32).view(n_chunks, S, R)
    lens_d = buf[2 * n:].view(n_chunks, S)
    parts = []
    for c in range(n_chunks):
        ok, ov, ol = kvstream.sort_chunks(keys[c], vals[c], lens_d[c],
                                          backend=backend, cap_s=cap_s)
        stats.n_mssort += 1
        stats.sort_elems += int(lens[c].sum())
        stats.chunk_loads += 1
        stats.chunk_stores += 1
        parts.append((ok, ov, ol, lens[c] > 0))
    return parts


def _take_chunk(K, V, lens, ptr, R):
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


def _put_rows(K, V, optr, src_k, src_v, n):
    """Append: write src[s, :n[s]] at K[s, optr[s]:...] with one scatter
    per array (no wait for the card).  K/V are (S, L + 1): the masked
    lanes all land in the spill column L, which the caller drops."""
    W = src_k.shape[1]
    spill = K.shape[1] - 1
    j = torch.arange(W, device=K.device)
    idx = torch.where(j[None, :] < n[:, None], optr[:, None] + j, spill)
    K.scatter_(1, idx, src_k)
    V.scatter_(1, idx, src_v)


def merge_round(A, B, R, backend, stats: SpzStats, acc, cap_s=None):
    """Merge a partition pair lock-step across streams, chunk by chunk:
    one K5 issue (``merge_chunks``) per step, then the copy-through of
    the side that is left.

    A, B: (keys (S, La), vals, lens (S,), live (S,) host bool) padded
    partitions on the device.  ``acc``: a (2, S) int64 device tensor
    that gathers the zip elements per stream (row 0) and the tail stores
    (element [1, 0]), read once per call.  The loop waits for the card
    once per issue, to learn whether any stream still has both sides;
    whether any does before the first issue is known on the host.
    Returns the merged (keys (S, La+Lb), vals, lens, live)."""
    (Ka, Va, lens_a, live_a), (Kb, Vb, lens_b, live_b) = A, B
    S, La = Ka.shape
    Lo = La + Kb.shape[1]
    dev = Ka.device
    Ko = torch.full((S, Lo + 1), EMPTY, dtype=torch.int32, device=dev)
    Vo = torch.zeros((S, Lo + 1), dtype=torch.float32, device=dev)
    lens_a, lens_b = lens_a.long(), lens_b.long()
    pa = torch.zeros(S, dtype=torch.int64, device=dev)
    pb = torch.zeros_like(pa)
    optr = torch.zeros_like(pa)
    if (live_a & live_b).any():
        # only streams with BOTH sides unexhausted participate (the
        # copy-through below handles the rest)
        both = (lens_a > 0) & (lens_b > 0)
        while True:
            ka, va, la = _take_chunk(Ka, Va, torch.where(both, lens_a, 0),
                                     pa, R)
            kb_, vb, lb = _take_chunk(Kb, Vb, torch.where(both, lens_b, 0),
                                      pb, R)
            klo, vlo, khi, vhi, ca, cb, ol = kvstream.merge_chunks(
                ka, va, la, kb_, vb, lb, backend=backend, cap_s=cap_s)
            stats.n_mszip += 1
            stats.chunk_loads += 2
            stats.chunk_stores += 1
            acc[0] += la
            acc[0] += lb
            _put_rows(Ko, Vo, optr, torch.cat([klo, khi], 1),
                      torch.cat([vlo, vhi], 1), ol)
            optr += ol
            pa += ca
            pb += cb
            both = (pa < lens_a) & (pb < lens_b)
            if not bool(both.any()):  # the issue's one wait for the card
                break
    # copy-through tails (one side exhausted)
    for K, V, lens, ptr, live in ((Ka, Va, lens_a, pa, live_a),
                                  (Kb, Vb, lens_b, pb, live_b)):
        if not live.any():
            continue
        rem = (lens - ptr).clamp(min=0)
        src_k, src_v, _ = _take_chunk(K, V, lens, ptr, K.shape[1])
        _put_rows(Ko, Vo, optr, src_k, src_v, rem)
        optr += rem
        acc[1, 0] += ((rem + R - 1) // R).max()
    return Ko[:, :Lo], Vo[:, :Lo], optr, live_a | live_b


def merge_tree_host(parts, R, backend, stats: SpzStats, acc, cap_s=None):
    """Zip-merge tree: halve the partition count per round, lock-step;
    an odd partition passes through.  Returns the single surviving
    partition (keys, vals, lens, live) or None."""
    while len(parts) > 1:
        nxt = []
        for j in range(0, len(parts) - 1, 2):
            nxt.append(merge_round(parts[j], parts[j + 1], R, backend,
                                   stats, acc, cap_s=cap_s))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0] if parts else None


def _spz_host_driver(A, B, R, S, order, backend, stats, device):
    """The paper-faithful lock-step driver: one kernel issue per chunk.
    Expansion runs on the host (``t_expand``); each group's products go
    to the card once and its partitions stay there.  Returns the groups'
    (row ids, keys, vals, lens) for :func:`_coo_parts_to_csr`; the device
    counters are read once, at the end."""
    a_indptr, a_idx, a_val = csr_to_numpy(A)
    b_indptr, b_idx, b_val = csr_to_numpy(B)
    coo: list = []
    totals = torch.zeros(2, dtype=torch.int64, device=device)
    for g0 in range(0, A.n_rows, S):
        rows = order[g0:g0 + S]
        cap_g = _group_cap(len(rows), S)
        t1 = time.perf_counter()
        products = expand_group(rows, a_indptr, a_idx, a_val,
                                b_indptr, b_idx, b_val)
        t2 = time.perf_counter()
        stats.t_expand += t2 - t1
        parts = sort_phase(products, R, len(rows), backend, stats,
                           cap_s=cap_g, device=device)
        acc = torch.zeros((2, len(rows)), dtype=torch.int64, device=device)
        final = merge_tree_host(parts, R, backend, stats, acc, cap_s=cap_g)
        if final is not None:
            row_ids = _to_device(np.asarray(rows, np.int64), device)
            coo.append((row_ids, *final[:3]))
            totals += acc.sum(1)
        stats.t_sort += time.perf_counter() - t2
    zip_elems, tails = totals.tolist()
    stats.zip_elems += zip_elems
    stats.chunk_stores += tails
    return coo


def _expand_geometry(a_indptr, a_idx, b_indptr):
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


def _fused_expand(row_ids, lane_ids, a_indptr, a_idx, a_val,
                  b_indptr, b_idx, b_val, L: int, geometry=None):
    """Device-side expansion: per-stream padded partial products.

    row_ids/lane_ids: (S,) — stream s expands output row ``row_ids[s]``
    of batch lane ``lane_ids[s]`` (row_ids < 0 marks padding streams).
    Matrix arrays are (batch, ...) stacked.  ``geometry``: the
    :func:`_expand_geometry` of these matrices, when the caller has it.
    Returns (keys (S, L) int32, vals (S, L) float32, plens (S,) int32)
    with EMPTY/0 padding."""
    Bn, n_rows1 = a_indptr.shape
    nnz_cap = a_idx.shape[1]
    bcap = b_idx.shape[1]
    dev = a_idx.device
    wcum0, wflat, offs = geometry or _expand_geometry(a_indptr, a_idx,
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


def _fused_bucket_impl(row_ids, lane_ids, a_indptr, a_idx, a_val,
                       b_indptr, b_idx, b_val, R: int, L: int, backend,
                       geometry=None):
    """One work bucket of a lock-step group: expansion, chunk sort, and
    the whole zip-merge tree.  Returns (keys (N, L), vals, lens (N,),
    rounds) where rounds carries the per-(round, pair) merge counters."""
    keys, vals, plens = _fused_expand(row_ids, lane_ids, a_indptr, a_idx,
                                      a_val, b_indptr, b_idx, b_val, L,
                                      geometry)
    return kvstream.fused_sort_merge(keys, vals, plens, R=R,
                                     backend=backend, detailed=True)


def _pow2_chunks(max_plen: int, R: int) -> int:
    """Partition count for the merge tree: next pow2 >= ceil(max_plen/R)."""
    q = -(-int(max_plen) // R)
    return 1 << max(0, q - 1).bit_length()


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array to ``device`` without waiting for the card: pinned
    staging makes the copy asynchronous."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def fused_process_group(items, plens, mats, R, backend, stats: SpzStats,
                        coo: list, geometry=None):
    """Run one lock-step group of work items through the fused pipeline.

    items: [(lane, row)] output rows of the group; plens: per-item product
    counts (host); mats: six (batch, ...) stacked CSR arrays on the
    device.  Each bucket's padded (row_ids, keys, vals, lens) is appended
    to ``coo`` for one assembly per call.

    Streams are bucketed by their own pow2 chunk count so a skewed group
    does not pad every stream to the group-max width.  The payload per
    stream is independent of which streams share a kernel; the lock-step
    instruction counts are group-wide, so they are rebuilt exactly from
    the per-(round, pair) bucket counters — a pair's issue count is the
    max per-stream step count (elementwise max over buckets), zip_elems
    a plain sum.  Sort-phase counters depend only on plens and are added
    to ``stats`` here.  Returns the group's merge counters as a device
    tensor [n_mszip, zip_elems, tail stores] (None for an empty group),
    so the caller reads them once per call."""
    buckets: dict[int, list[int]] = {}
    for ix, pl in enumerate(plens):
        if pl:
            buckets.setdefault(_pow2_chunks(int(pl), R), []).append(ix)
    if not buckets:
        return None
    device = mats[0].device
    max_plen = int(plens.max())
    n_used = -(-max_plen // R)
    stats.n_mssort += n_used
    stats.sort_elems += int(plens.sum())
    stats.chunk_loads += n_used
    stats.chunk_stores += n_used
    # group accumulators in the counter-plane layout of the widest bucket
    # Cg: round k's pairs at columns [Cg - Cg>>k, Cg - Cg>>(k+1)); bucket
    # C_b's round k fills the first C_b>>(k+1) of them
    Cg = max(buckets)
    order = sorted(buckets)
    sizes = [1 << max(0, len(buckets[c]) - 1).bit_length() for c in order]
    row_ids = np.full(sum(sizes), -1, np.int64)
    lane_ids = np.zeros(sum(sizes), np.int64)
    at = 0
    for C_b, Nb in zip(order, sizes):
        for t, ix in enumerate(buckets[C_b]):
            lane_ids[at + t], row_ids[at + t] = items[ix]
        at += Nb
    cols = [Cg - (Cg >> k) + np.arange(C_b >> (k + 1))
            for C_b in order for k in range(C_b.bit_length() - 1)]
    # one host-to-device copy per group: row ids, lane ids, column maps
    ids = _to_device(np.concatenate([row_ids, lane_ids, *cols]), device)
    n = len(row_ids)
    row_dev, lane_dev, col_dev = ids[:n], ids[n:2 * n], ids[2 * n:]
    steps_acc = torch.zeros(max(Cg - 1, 1), dtype=torch.int64, device=device)
    tails_acc = torch.zeros((max(Cg - 1, 1), 2), dtype=torch.int64,
                            device=device)
    zips = []
    at = at_col = 0
    for C_b, Nb in zip(order, sizes):
        rows = row_dev[at:at + Nb]
        mk, mv, ml, rounds = _fused_bucket_impl(
            rows, lane_dev[at:at + Nb], *mats, R=R, L=C_b * R,
            backend=backend, geometry=geometry)
        at += Nb
        if rounds:
            idx = col_dev[at_col:at_col + C_b - 1]
            at_col += C_b - 1
            steps_acc.scatter_reduce_(0, idx, torch.cat([r[0] for r in rounds]),
                                      "amax")
            tails_acc.scatter_reduce_(0, idx[:, None].expand(-1, 2),
                                      torch.cat([r[2] for r in rounds]), "amax")
            zips.extend(r[1] for r in rounds)
        coo.append((rows, mk, mv, ml))
    zip_elems = torch.stack(zips).sum() if zips else steps_acc.new_zeros(())
    return torch.stack([steps_acc.sum(), zip_elems, tails_acc.sum()])


def _group_cap(Sg: int, S: int) -> int:
    """Pad kernel issues to the next pow2 >= Sg (capped at S): bounds the
    number of distinct launch shapes without inflating a small matrix's
    groups all the way to S streams."""
    return min(S, 1 << max(0, Sg - 1).bit_length())


def _spz_fused_driver(A, B, R, S, order, work, backend, stats):
    """Device-resident driver: per lock-step group, the work-bucketed
    expand/sort/merge-tree pipelines run on the device with no host wait;
    the merge counters are summed on the device and read once here."""
    coo: list = []
    mats = (A.indptr[None], A.indices[None], A.data[None],
            B.indptr[None], B.indices[None], B.data[None])
    geometry = _expand_geometry(mats[0], mats[1], mats[3])
    totals = torch.zeros(3, dtype=torch.int64, device=A.device)
    t1 = time.perf_counter()
    for g0 in range(0, A.n_rows, S):
        rows = order[g0:g0 + S]
        items = [(0, int(i)) for i in rows]
        group = fused_process_group(items, work[rows], mats, R, backend,
                                    stats, coo=coo, geometry=geometry)
        if group is not None:
            totals += group
    stats.t_sort += time.perf_counter() - t1
    n_zip, zip_elems, tails = totals.tolist()
    stats.n_mszip += n_zip
    stats.zip_elems += zip_elems
    stats.chunk_loads += 2 * n_zip
    stats.chunk_stores += n_zip + tails
    return coo


def _coo_parts_to_csr(coo, shape, device) -> CSR:
    """Assemble the spz drivers' padded (row ids, keys, vals, lens) parts
    into the output CSR on ``device``, dropping exact zeros like the
    scalar engines.

    Every output row is one stream of one bucket and its columns are
    ascending and unique, so a stable sort by row gives the (row, col)
    order, and the values are the products' sums unchanged — the CSR
    ``csr_from_coo`` builds from the same triples, without the host trip."""
    if not coo:
        return csr_from_coo([], [], [], shape).to(device)
    rows, cols, vals, keep = [], [], [], []
    for row_ids, mk, mv, ml in coo:
        N, L = mk.shape
        rows.append(row_ids[:, None].expand(N, L).reshape(-1))
        cols.append(mk.reshape(-1))
        vals.append(mv.reshape(-1))
        valid = torch.arange(L, device=device)[None, :] < ml[:, None]
        keep.append((valid & (mv != 0.0)).reshape(-1))
    keep = torch.cat(keep)
    rows = torch.cat(rows)[keep]
    cols = torch.cat(cols)[keep]
    vals = torch.cat(vals)[keep]
    rows, order = torch.sort(rows, stable=True)
    return _sorted_coo_to_csr(rows, cols[order], vals[order], shape)


def _sorted_coo_to_csr(rows, cols, vals, shape) -> CSR:
    """The CSR ``csr_from_coo`` builds from unique triples sorted by
    (row, col), assembled on their device."""
    device = rows.device
    nnz = rows.numel()
    indptr = torch.searchsorted(
        rows, torch.arange(shape[0] + 1, dtype=rows.dtype, device=device))
    cap = max(nnz, 1)
    indices = torch.full((cap,), EMPTY, dtype=torch.int32, device=device)
    data = torch.zeros(cap, dtype=torch.float32, device=device)
    indices[:nnz] = cols
    data[:nnz] = vals
    return CSR(indptr.to(torch.int32), indices, data, shape)


def spgemm_spz(A: CSR, B: CSR, *, R: int = 16, S: int | None = None,
               rsort: bool = False, backend="auto", driver: str = "fused",
               device=None):
    """Merge-based SpGEMM using the SparseZipper primitives.

    R: chunk width (paper: 16).
    S: lock-step stream count per kernel issue (default 32*R).
    rsort: pre-sort row indices by per-row work (spz-rsort).
    backend: kernel backend for the stream primitives — "torch", "cuda",
       "auto" (cuda on a CUDA device, torch elsewhere), or a resolved
       ``KernelBackend``; unknown names raise ``ValueError``.  Both are
       bit-compatible, so this is purely a performance knob.
    driver: "fused" (default) — expansion, chunk sort and the whole
       zip-merge tree on the device per (S, L, R) bucket; "host" — the
       lock-step driver, one K4 (sort) or K5 (merge) issue per chunk,
       expansion on the host, with the ``t_expand``/``t_sort``/
       ``t_output`` breakdown.  Both give the same CSR and the same
       n_mssort, sort_elems, n_mszip and zip_elems.
    device: where to run; default the card ("cuda"), which raises when
       no card is present.  Operands are moved there.
    Returns (CSR on ``device``, SpzStats)."""
    S = S or 32 * R
    stats = SpzStats()
    if driver not in ("fused", "host"):
        raise ValueError(f"unknown spz driver {driver!r}; use 'fused'|'host'")
    device = resolve_device(device)
    bk = kb.resolve_backend(backend, device)  # unknown names raise
    shape = (A.n_rows, B.n_cols)
    if A.n_rows == 0:
        return csr_from_coo([], [], [], shape).to(device), stats
    t0 = time.perf_counter()
    work = row_work(A, B) if (rsort or driver == "fused") else None
    order = np.argsort(work, kind="stable") if rsort else np.arange(A.n_rows)
    stats.t_preprocess = time.perf_counter() - t0
    if driver == "host":
        coo = _spz_host_driver(A, B, R, S, order, bk, stats, device)
    else:
        coo = _spz_fused_driver(A.to(device), B.to(device), R, S, order,
                                work, bk, stats)
    t3 = time.perf_counter()
    out = _coo_parts_to_csr(coo, shape, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.t_output = time.perf_counter() - t3
    return out, stats
