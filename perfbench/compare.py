"""The comparison that decides ``correct``.

Two numbers are compared for every product that is judged, against the
reference's entries (every (row, column) that has a product, see
``reference.spgemm``):

* ``structure``: output entries whose (row, column) has no product, and
  row pointers or column orders that are not a CSR of unique ascending
  columns; a product that never came counts every entry.  Exact: limit 0.
* ``value_err``: the widest gap between the output's value and the float64
  reference's, over every entry with a product, as a share of that entry's
  ``sum |a_ik b_kj|`` (the scale a float32 summation error grows with).
  An entry the output lacks reads 0: the program drops a sum that is
  exactly zero in float32, which is right where the float64 sum is within
  rounding of zero, and a lost entry reads its whole value.

``LIMITS`` holds the limit of each; ``PERF.md`` gives the readings that
each limit was set from.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"structure": 0, "value_err": 1e-4}


def _keys(indptr: np.ndarray, indices: np.ndarray, n_cols: int):
    """(key = row * n_cols + col per entry, number of entries that break
    the CSR form: row pointers going back or past the entries, columns out
    of range, or columns not strictly ascending within a row)."""
    indptr = np.asarray(indptr, np.int64)
    n_rows = len(indptr) - 1
    bad = int(np.count_nonzero(np.diff(indptr) < 0))
    if bad or indptr[0] != 0 or indptr[-1] != len(indices):
        return np.zeros(0, np.int64), max(bad, 1) + len(indices)
    cols = np.asarray(indices, np.int64)
    bad = int(np.count_nonzero((cols < 0) | (cols >= n_cols)))
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    key = rows * n_cols + cols
    return key, bad + int(np.count_nonzero(np.diff(key) <= 0))


def compare(out, ref, n_cols: int) -> dict:
    """The compared numbers of one product.  ``out``: the program's
    ``(indptr, indices, data)`` cut to its nnz, or None for a product that
    never came; ``ref``: the reference's ``(indptr, indices, data,
    scale)``."""
    r_key, _ = _keys(ref[0], ref[1], n_cols)
    if out is None:
        return {"structure": len(r_key), "value_err": 0.0}
    o_key, bad = _keys(out[0], out[1], n_cols)
    if bad:
        _, oi, ri = np.intersect1d(o_key, r_key, assume_unique=False,
                                   return_indices=True)
    else:   # both strictly ascending: look each output key up
        pos = np.minimum(np.searchsorted(r_key, o_key),
                         max(len(r_key) - 1, 0))
        oi = np.flatnonzero(r_key[pos] == o_key) if len(r_key) else \
            np.zeros(0, np.int64)
        ri = pos[oi]
    got = np.zeros(len(r_key))
    got[ri] = np.asarray(out[2], np.float64)[oi]
    # an entry whose every product is 0 (an input value of exactly 0) has
    # scale 0: it agrees where the output reads 0 too
    diff = np.abs(got - ref[2])
    err = np.divide(diff, ref[3], out=np.where(diff > 0, np.inf, 0.0),
                    where=ref[3] > 0)
    value_err = float(err.max()) if len(err) else 0.0
    if not np.isfinite(value_err) and len(err):
        value_err = float("inf")
    return {"structure": int(bad + len(o_key) - len(oi)),
            "value_err": value_err}


def merge(results: list[dict]) -> dict:
    """The numbers of several products: structure errors summed, the
    widest value gap."""
    return {"structure": sum(r["structure"] for r in results),
            "value_err": max((r["value_err"] for r in results),
                             default=0.0)}


def passes(numbers: dict, limits: dict = LIMITS) -> bool:
    """Every number within its limit (a NaN or inf is not)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
