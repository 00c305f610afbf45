"""Padded CSR sparse matrices as torch tensors.

The layout is the JAX package's (``repro.core.formats``): ``indices`` and
``data`` have a fixed capacity ``nnz_cap``, rows are delimited by
``indptr`` as in classic CSR, and padding slots carry the sentinel key
``EMPTY`` (INT32_MAX) so they sort after every valid column index.  All
index tensors are ``torch.int32`` and values ``torch.float32`` (torch
defaults to int64, so every constructor pins the dtype).

Host-side constructors (``csr_from_coo``, ``random_sparse``, ...) build
on the CPU with numpy, draw from the same numpy RNG calls as the JAX
package (equal seeds give byte-equal matrices), and return CPU tensors;
``CSR.to(device)`` moves a matrix to the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# the sentinel key, EMPTY = INT32_MAX: sorts after every valid column index
from repro_torch.kernels.merge_tree import EMPTY


class InvalidOperand(ValueError):
    """Structured rejection of a malformed sparse operand.

    Raised at the dispatch boundary instead of letting a non-monotonic
    ``indptr`` or out-of-range column index flow into a kernel, where it
    produces garbage output or an out-of-bounds read.  ``field`` names
    the offending piece (e.g. ``"A.indptr"``)."""

    def __init__(self, field: str, message: str):
        self.field = field
        super().__init__(f"{field}: {message}")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def validate_csr(m: "CSR", name: str = "operand") -> None:
    """Screen a padded CSR for structural corruption; raise
    :class:`InvalidOperand` naming the bad field, or return None.

    Checks (in order): field dtypes, indptr shape/monotonicity/range
    against ``nnz_cap``, column indices within ``[0, n_cols)`` over the
    valid region, and finite values.  O(nnz) host work, paid once per
    request at plan time."""
    if len(m.shape) != 2 or m.shape[0] < 1 or m.shape[1] < 1:
        raise InvalidOperand(f"{name}.shape", f"not a matrix shape: {m.shape}")
    indptr = _host(m.indptr)
    if indptr.dtype.kind not in "iu":
        raise InvalidOperand(f"{name}.indptr",
                             f"expected integer dtype, got {indptr.dtype}")
    if indptr.ndim != 1 or indptr.shape[0] != m.n_rows + 1:
        raise InvalidOperand(
            f"{name}.indptr",
            f"expected shape ({m.n_rows + 1},), got {indptr.shape}")
    if int(indptr[0]) != 0:
        raise InvalidOperand(f"{name}.indptr",
                             f"must start at 0, got {int(indptr[0])}")
    if (np.diff(indptr) < 0).any():
        drop = int(np.argmax(np.diff(indptr) < 0))
        raise InvalidOperand(f"{name}.indptr",
                             f"non-monotonic at row {drop}")
    indices = _host(m.indices)
    if indices.dtype.kind not in "iu":
        raise InvalidOperand(f"{name}.indices",
                             f"expected integer dtype, got {indices.dtype}")
    data = _host(m.data)
    if data.dtype.kind != "f":
        raise InvalidOperand(f"{name}.data",
                             f"expected floating dtype, got {data.dtype}")
    if indices.shape != data.shape or indices.ndim != 1:
        raise InvalidOperand(
            f"{name}.indices",
            f"indices/data capacity mismatch: {indices.shape} vs {data.shape}")
    nnz = int(indptr[-1])
    if nnz > m.nnz_cap:
        raise InvalidOperand(f"{name}.indptr",
                             f"nnz {nnz} exceeds capacity {m.nnz_cap}")
    live_idx = indices[:nnz]
    if nnz and (int(live_idx.min()) < 0 or int(live_idx.max()) >= m.n_cols):
        bad = int(live_idx[(live_idx < 0) | (live_idx >= m.n_cols)][0])
        raise InvalidOperand(f"{name}.indices",
                             f"column {bad} out of range [0, {m.n_cols})")
    if nnz and not np.isfinite(data[:nnz]).all():
        raise InvalidOperand(f"{name}.data", "non-finite value in payload")


def validate_operands(A: "CSR", B: "CSR") -> None:
    """Validate both sides of a multiply (see :func:`validate_csr`)."""
    validate_csr(A, "A")
    validate_csr(B, "B")
    if A.n_cols != B.n_rows:
        raise InvalidOperand("B.shape",
                             f"inner dims differ: {A.shape} @ {B.shape}")


@dataclasses.dataclass
class CSR:
    """Padded CSR matrix. ``indptr``: (n_rows+1,) int32; ``indices``/``data``:
    (nnz_cap,) with valid entries in [indptr[0], indptr[n_rows]) and padding
    (= EMPTY / 0) afterwards.  All three tensors live on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_cap(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def nnz(self):
        return self.indptr[-1]

    def to(self, device) -> "CSR":
        device = torch.device(device)
        if device == self.device:
            return self
        return CSR(self.indptr.to(device), self.indices.to(device),
                   self.data.to(device), self.shape)

    def to_dense(self) -> torch.Tensor:
        n_rows, n_cols = self.shape
        rows = row_ids_from_indptr(self.indptr, self.nnz_cap)
        valid = torch.arange(self.nnz_cap, device=self.device) < self.indptr[-1]
        r = torch.where(valid, rows, 0).long()
        c = torch.where(valid, self.indices, 0).long()
        v = torch.where(valid, self.data, 0.0)
        out = torch.zeros((n_rows, n_cols), dtype=self.data.dtype,
                          device=self.device)
        return out.index_put_((r, c), v, accumulate=True)


def row_ids_from_indptr(indptr: torch.Tensor, cap: int) -> torch.Tensor:
    """Expand CSR indptr into per-entry row ids (length ``cap``)."""
    n_rows = indptr.shape[0] - 1
    # row id of entry e = number of row starts <= e, minus 1
    e = torch.arange(cap, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(indptr[1:].contiguous(), e, right=True)
    return rows.to(torch.int32).clamp(0, max(n_rows - 1, 0))


def csr_from_numpy(indptr, indices, data, shape, device="cpu") -> CSR:
    """Wrap host arrays (e.g. one matrix built once with numpy and handed
    to both packages) as a CSR on ``device``, pinning int32/float32."""
    return CSR(torch.tensor(np.asarray(indptr, np.int32), device=device),
               torch.tensor(np.asarray(indices, np.int32), device=device),
               torch.tensor(np.asarray(data, np.float32), device=device),
               (int(shape[0]), int(shape[1])))


def csr_from_dense(dense, nnz_cap: int | None = None) -> CSR:
    """Build a padded CSR from a dense numpy array or tensor (host-side)."""
    dense = _host(dense)
    n_rows, n_cols = dense.shape
    r, c = np.nonzero(dense)
    v = dense[r, c]
    nnz = len(r)
    cap = nnz_cap if nnz_cap is not None else max(nnz, 1)
    if cap < nnz:
        raise ValueError(f"nnz_cap {cap} < nnz {nnz}")
    indptr = np.zeros(n_rows + 1, np.int32)
    np.add.at(indptr[1:], r, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.full(cap, EMPTY, np.int32)
    data = np.zeros(cap, np.float32)
    indices[:nnz] = c
    data[:nnz] = v
    return csr_from_numpy(indptr, indices, data, (n_rows, n_cols))


def csr_from_coo(rows, cols, vals, shape, nnz_cap: int | None = None) -> CSR:
    """Host-side COO→CSR (rows need not be sorted; duplicates are summed)."""
    rows = np.asarray(_host(rows), np.int64)
    cols = np.asarray(_host(cols), np.int64)
    vals = np.asarray(_host(vals))
    key = rows * shape[1] + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    if len(key):
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros(len(uniq), vals.dtype)
        np.add.at(acc, inv, vals)
        rows = (uniq // shape[1]).astype(np.int32)
        cols = (uniq % shape[1]).astype(np.int32)
        vals = acc
    nnz = len(rows)
    cap = nnz_cap if nnz_cap is not None else max(nnz, 1)
    indptr = np.zeros(shape[0] + 1, np.int32)
    np.add.at(indptr[1:], rows, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    indices = np.full(cap, EMPTY, np.int32)
    data = np.zeros(cap, np.float32)
    indices[:nnz] = cols
    data[:nnz] = vals.astype(np.float32)
    return csr_from_numpy(indptr, indices, data, shape)


def random_sparse(n_rows: int, n_cols: int, density: float, *, seed: int = 0,
                  pattern: str = "uniform", skew: float = 1.5) -> CSR:
    """Synthetic sparse matrices with controllable structure (the same
    numpy RNG calls as ``repro.core.formats.random_sparse``).

    pattern:
      uniform   — iid Bernoulli(density)
      powerlaw  — Zipf-distributed row degrees (graph-like, high work variance)
      banded    — nonzeros near the diagonal (scientific-simulation-like)
      blocked   — random dense blocks (mesh/FEM-like)
    """
    rng = np.random.default_rng(seed)
    target_nnz = max(1, int(n_rows * n_cols * density))
    if pattern == "uniform":
        rows = rng.integers(0, n_rows, target_nnz)
        cols = rng.integers(0, n_cols, target_nnz)
    elif pattern == "powerlaw":
        deg = rng.zipf(skew, n_rows).astype(np.int64)
        deg = np.minimum(deg * max(1, target_nnz // max(1, deg.sum())), n_cols // 2 + 1)
        # rescale to target nnz
        scale = target_nnz / max(1, deg.sum())
        deg = np.maximum(1, (deg * scale).astype(np.int64))
        rows = np.repeat(np.arange(n_rows), deg)
        cols = rng.integers(0, n_cols, len(rows))
    elif pattern == "banded":
        bw = max(2, int(density * n_cols * 4))
        rows = rng.integers(0, n_rows, target_nnz)
        offs = rng.integers(-bw, bw + 1, target_nnz)
        cols = np.clip(rows * n_cols // n_rows + offs, 0, n_cols - 1)
    elif pattern == "blocked":
        bs = 8
        nb = max(1, target_nnz // (bs * bs))
        br = rng.integers(0, max(1, n_rows - bs), nb)
        bc = rng.integers(0, max(1, n_cols - bs), nb)
        rr = br[:, None, None] + np.arange(bs)[None, :, None]
        cc = bc[:, None, None] + np.arange(bs)[None, None, :]
        rows = np.broadcast_to(rr, (nb, bs, bs)).reshape(-1)
        cols = np.broadcast_to(cc, (nb, bs, bs)).reshape(-1)
    else:
        raise ValueError(f"unknown pattern {pattern}")
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return csr_from_coo(rows, cols, vals, (n_rows, n_cols))


def csr_to_numpy(m: CSR):
    """Return (indptr, indices, data) as numpy, truncated to true nnz."""
    indptr = _host(m.indptr)
    nnz = int(indptr[-1])
    return indptr, _host(m.indices)[:nnz], _host(m.data)[:nnz]
