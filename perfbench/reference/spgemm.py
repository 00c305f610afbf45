"""Plain PyTorch SpGEMM: the reference that decides ``correct``, and its
lower-precision control.

It imports nothing of the program and takes nothing the program made: it
works ``C = A B`` out again from the CSR arrays the benchmark generated,
in plain torch operations (expand every product, one sort by (row, col),
segment sums), on the CPU or on the card once the program's state is
freed.

``spgemm`` computes every product in float64 (a float32 times a float32 is
exact there) and sums them in float64; beside each sum it keeps the sum of
the products' magnitudes, the scale a float32 summation error is measured
against.  It returns every entry that has a product, a sum that cancels to
zero included: whether a float32 sum cancels exactly is a matter of
rounding, so ``compare`` judges a missing entry by its value.
``spgemm_bf16`` is the control: the same product computed in bfloat16, the
precision below the configuration's float32 (inputs, products and every
partial sum rounded to bfloat16, summed in column order), with the
program's semantics: columns ascending and unique in each row, an entry
whose sum is exactly zero dropped.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(x, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                      dtype=dtype)


def _expand(a, b, n_cols: int, device):
    """The products of A·B, sorted stably by (row, col): their keys ``row *
    n_cols + col`` and the A and B entries each multiplies."""
    i64 = torch.int64
    a_ptr, a_idx = _t(a[0], device, i64), _t(a[1], device, i64)
    b_ptr, b_idx = _t(b[0], device, i64), _t(b[1], device, i64)
    cnt = (b_ptr[1:] - b_ptr[:-1])[a_idx]
    total = int(cnt.sum())
    a_ent = torch.repeat_interleave(
        torch.arange(len(a_idx), device=device), cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    b_ent = (torch.arange(total, device=device) - first[a_ent]
             + b_ptr[a_idx][a_ent])
    rows = torch.repeat_interleave(torch.arange(len(a_ptr) - 1,
                                                device=device),
                                   a_ptr[1:] - a_ptr[:-1])
    key, order = torch.sort(rows[a_ent] * n_cols + b_idx[b_ent], stable=True)
    return key, a_ent[order], b_ent[order]


def _csr(keys: torch.Tensor, n_rows: int, n_cols: int):
    """(indptr int64, indices int32), numpy, of sorted unique keys."""
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(torch.bincount(keys // n_cols, minlength=n_rows).cpu().numpy(),
              out=indptr[1:])
    return indptr, (keys % n_cols).to(torch.int32).cpu().numpy()


def spgemm(a, b, n_cols: int, device="cpu"):
    """``C = A B`` for CSR triples ``a = (indptr, indices, data)`` and
    ``b``, with ``n_cols`` columns in B.  Returns numpy ``(indptr int64,
    indices int32, data float64, scale float64)`` over every entry with a
    product: ``scale`` is the sum of ``|a_ik b_kj|`` over its products."""
    key, ae, be = _expand(a, b, n_cols, device)
    prod = (_t(a[2], device, torch.float64)[ae]
            * _t(b[2], device, torch.float64)[be])
    del ae, be
    keys, group = torch.unique_consecutive(key, return_inverse=True)
    del key
    vals = torch.zeros(len(keys), dtype=torch.float64, device=device)
    scale = torch.zeros_like(vals)
    vals.index_add_(0, group, prod)
    scale.index_add_(0, group, prod.abs())
    indptr, indices = _csr(keys, len(a[0]) - 1, n_cols)
    return indptr, indices, vals.cpu().numpy(), scale.cpu().numpy()


def to_bf16(x):
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float32
    (numpy in, numpy out; a tensor in, a tensor out)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(torch.float32)
    return to_bf16(torch.as_tensor(np.asarray(x, np.float32))).numpy()


def spgemm_bf16(a, b, n_cols: int, device="cpu"):
    """The control: ``C = A B`` in bfloat16.  Returns numpy ``(indptr
    int64, indices int32, data float32)``, every value bfloat16-exact and
    exact zeros dropped."""
    key, ae, be = _expand(a, b, n_cols, device)
    f32 = torch.float32
    prod = to_bf16(to_bf16(_t(a[2], device, f32))[ae]
                   * to_bf16(_t(b[2], device, f32))[be])
    keys, group, counts = torch.unique_consecutive(
        key, return_inverse=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(key), device=device) - starts[group]
    rank, by_rank = torch.sort(rank, stable=True)
    bounds = torch.searchsorted(
        rank, torch.arange(int(counts.max()) + 1 if len(counts) else 0,
                           device=device)).tolist()
    acc = torch.zeros(len(keys), dtype=f32, device=device)
    # the r-th product of every entry is added in pass r: each entry's
    # partial sums follow its columns' order, one rounding per addition
    for r in range(len(bounds) - 1):
        sel = by_rank[bounds[r]:bounds[r + 1]]
        acc[group[sel]] = to_bf16(acc[group[sel]] + prod[sel])
    keep = acc != 0.0
    indptr, indices = _csr(keys[keep], len(a[0]) - 1, n_cols)
    return indptr, indices, acc[keep].cpu().numpy()
