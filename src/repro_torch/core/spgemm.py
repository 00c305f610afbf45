"""Row-wise (Gustavson) SpGEMM engines: the spz fused driver and its oracle.

Port of the main path of ``repro.core.spgemm``:

  scl-array  — scalar row loop with a dense accumulator row (the oracle;
               numpy on the host)
  spz        — merge-based SpGEMM on the SparseZipper primitives: chunked
               stream sort + zip-merge tree with data-dependent advancement,
               lock-step groups of S streams, through the device-resident
               "fused" driver (expand, then one ``fused_sort_merge`` per
               work bucket)
  spz-rsort  — spz with rows pre-sorted by per-row work

The fused driver keeps every bucket's output and counters on the device
and reads them back once per call: the output as one COO assembly, the
counters as one small tensor.  ``driver="host"`` (the per-chunk
lock-step driver) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import stream as kvstream
from repro_torch.core.formats import CSR, EMPTY, csr_from_coo, csr_to_numpy
from repro_torch.kernels import backend as kb


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


# ---------------------------------------------------------------------------
# SparseZipper merge-based SpGEMM (spz / spz-rsort), fused driver
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
    t_sort: float = 0.0        # stream sorting + merging (host enqueue)
    t_output: float = 0.0      # output generation, incl. the device wait


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
    """Assemble the fused driver's padded bucket outputs into the output
    CSR on ``device``, dropping exact zeros like the scalar engines.

    Every output row is one stream of one bucket and its columns are
    ascending and unique, so a stable sort by row gives the (row, col)
    order, and the values are the products' sums unchanged — the CSR
    ``csr_from_coo`` builds from the same triples, without the host trip."""
    n_rows = shape[0]
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
    nnz = rows.numel()
    indptr = torch.searchsorted(
        rows, torch.arange(n_rows + 1, dtype=rows.dtype, device=device))
    cap = max(nnz, 1)
    indices = torch.full((cap,), EMPTY, dtype=torch.int32, device=device)
    data = torch.zeros(cap, dtype=torch.float32, device=device)
    indices[:nnz] = cols[order]
    data[:nnz] = vals[order]
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
    driver: "fused" — expansion, chunk sort and the whole zip-merge tree
       on the device per (S, L, R) bucket.  "host" is not ported yet.
    device: where to run; default the card ("cuda"), which raises when
       no card is present.  Operands are moved there.
    Returns (CSR on ``device``, SpzStats)."""
    S = S or 32 * R
    stats = SpzStats()
    if driver == "host":
        raise NotImplementedError(
            "spz driver='host' is not ported yet (ROADMAP.md queue 1, "
            "item 6: the spz host driver)")
    if driver != "fused":
        raise ValueError(f"unknown spz driver {driver!r}; use 'fused'")
    device = resolve_device(device)
    bk = kb.resolve_backend(backend, device)  # unknown names raise
    shape = (A.n_rows, B.n_cols)
    if A.n_rows == 0:
        return csr_from_coo([], [], [], shape).to(device), stats
    t0 = time.perf_counter()
    work = row_work(A, B)
    order = np.argsort(work, kind="stable") if rsort else np.arange(A.n_rows)
    stats.t_preprocess = time.perf_counter() - t0
    coo = _spz_fused_driver(A.to(device), B.to(device), R, S, order, work,
                            bk, stats)
    t3 = time.perf_counter()
    out = _coo_parts_to_csr(coo, shape, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats.t_output = time.perf_counter() - t3
    return out, stats
