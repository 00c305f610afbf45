"""The benchmark's inputs: sparse matrices drawn from a configuration and a seed.

A configuration names its pattern generator (``"pattern"``), a module of
its own in ``patterns/<name>.py`` whose ``pattern(cfg)`` returns the
sparsity pattern as CSR ``(indptr, indices)``.  The pattern is fixed by the
configuration, as a published matrix has one; its generator takes no
notice of the run's seed.

The run's ``--seed`` then draws fresh float32 values and, where the
configuration sets ``"permute"``, a symmetric permutation ``P A P^T`` of
the pattern.  ``(P A P^T)(P A P^T) = P (A A) P^T``, so every seed gives
the same products, the same output nonzeros and the same row work, in
another row order and with other values.
"""
from __future__ import annotations

import numpy as np

from perfbench import load_module

MASK64 = (1 << 64) - 1


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
    """The seed sequence of a run's ``--seed`` (any whole number, negative
    ones included) and a spawn key naming what it draws."""
    return np.random.SeedSequence(int(seed) & MASK64, spawn_key=key)


def csr_pattern(rows: np.ndarray, cols: np.ndarray, n_rows: int,
                n_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int32, indices int32) of the unique (row, col) pairs, rows
    in order and columns ascending within each row."""
    key = np.unique(rows.astype(np.int64) * n_cols + cols.astype(np.int64))
    r = key // n_cols
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n_rows), out=indptr[1:])
    return indptr.astype(np.int32), (key % n_cols).astype(np.int32)


def pattern(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's sparsity pattern as CSR (indptr, indices), from
    the generator it names (``patterns/<cfg["pattern"]>.py``)."""
    return load_module("patterns", cfg["pattern"]).pattern(cfg)


def draw(cfg: dict, seed: int, lane: int = 0,
         base: tuple[np.ndarray, np.ndarray] | None = None,
         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One matrix of the configuration for ``seed``: the pattern, under a
    symmetric permutation drawn from the seed where the configuration sets
    ``"permute"``, with standard normal float32 values.  ``lane`` names an
    independent draw; ``base``: the pattern, if the caller already holds
    it.  Returns CSR (indptr int32, indices int32, data float32)."""
    indptr, indices = pattern(cfg) if base is None else base
    n = len(indptr) - 1
    rng = np.random.default_rng(seed_sequence(seed, 1, lane))
    if cfg.get("permute"):
        if int(cfg["rows"]) != int(cfg["cols"]):
            raise ValueError("a symmetric permutation needs a square matrix")
        perm = rng.permutation(n)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        indptr, indices = csr_pattern(perm[rows], perm[indices], n, n)
    data = rng.standard_normal(len(indices), dtype=np.float32)
    return indptr, indices, data


def row_work(indptr_a: np.ndarray, indices_a: np.ndarray,
             indptr_b: np.ndarray) -> np.ndarray:
    """Products (multiplications) of each output row of A·B."""
    blen = np.diff(indptr_b).astype(np.int64)
    rows = np.repeat(np.arange(len(indptr_a) - 1), np.diff(indptr_a))
    return np.bincount(rows, weights=blen[indices_a],
                       minlength=len(indptr_a) - 1).astype(np.int64)
