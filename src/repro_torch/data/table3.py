"""Synthetic stand-ins for the paper's SuiteSparse matrices (Table III).

The counterpart of the JAX package's ``benchmarks/datasets.py`` (which
imports that package, so the port keeps its own copy).  Each evaluated
matrix is replaced by a generator matched on density, average per-row
work and per-16-row work variance, at ~1-2K rows.  Unlike the JAX copy,
which seeds with ``abs(hash(name))`` (randomized per process), every
seed here is fixed, so a matrix is the same in every process: tests
build it once with numpy and hand the same arrays to both packages.

Besides the 13 ``SPECS``, three stand-ins at SuiteSparse scale exercise
the card (``FULL``):

  cage11-full       uniform, 39,082 rows and 559,722 sampled entries
                    (559,614 after duplicate merge), the SuiteSparse
                    Matrix Collection's vanHeukelum/cage11
  email-Enron-full  powerlaw with skew 1.3 (as ``email`` in SPECS),
                    36,692 rows, density chosen for SNAP/email-Enron's
                    367,662 nnz (368,197 generated with numpy 2.0; the
                    Zipf draws may differ slightly between numpy versions)
  hub-full          cage11-full with row 0 given 2,048 nnz at uniform
                    random columns — the hub row power-law graphs have.
                    Its A·A row 0 holds ~29K products, so its bucket has
                    L = 32,768 and takes the large-bucket route of
                    ``kernels/fused_bucket.py``.

and one port-owned stand-in for the longest rows (``LONG_ROW``):

  dense-row-full    cage11-full with row 0 made dense (all 39,082
                    columns).  Its A·A row 0 holds the sum of all row
                    lengths (~560K > 524,288) products, so its bucket has
                    L = 2^20 and the last merge round of the large route
                    merges La + Lb = 2^20 slots: more ballot bits than a
                    block's shared memory holds, so K2 keeps them in
                    device memory.
"""
from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.formats import (CSR, csr_from_coo, csr_to_numpy,
                                      random_sparse)

# (paper name, pattern, n_rows, density, skew) — ordered like Table III
# (descending per-16-row work variance).
SPECS = [
    ("p2p",      "powerlaw", 1024, 3.0e-3, 2.2),   # tiny work, high var
    ("wiki",     "powerlaw",  768, 1.6e-2, 1.7),   # heavy rows, high var
    ("soc",      "powerlaw", 1024, 1.0e-2, 1.8),
    ("ca-cm",    "powerlaw", 1024, 7.0e-3, 1.5),
    ("ndwww",    "powerlaw", 1536, 2.5e-3, 1.6),
    ("patents",  "uniform",  1536, 1.5e-3, 0.0),
    ("email",    "powerlaw", 1024, 6.0e-3, 1.3),
    ("scircuit", "banded",   1024, 4.0e-3, 0.0),
    ("bcsstk17", "blocked",   768, 2.5e-2, 0.0),   # dup-heavy compression
    ("usroads",  "banded",   1536, 1.5e-3, 0.0),   # work < chunk width
    ("p3d",      "banded",    768, 2.5e-2, 0.0),
    ("cage11",   "uniform",  1024, 4.0e-3, 0.0),
    ("m133-b3",  "uniform",  1536, 2.6e-3, 0.0),   # exactly-regular rows
]

# name -> (pattern, n_rows, density, skew, seed) at SuiteSparse scale
FULL = {
    "cage11-full": ("uniform", 39082, 559722 / 39082 ** 2, 1.5, 39082),
    "email-Enron-full": ("powerlaw", 36692, 2.571e-4, 1.3, 36692),
}
HUB_ROW_NNZ = 2048
LONG_ROW = "dense-row-full"


def seed_of(name: str) -> int:
    """Fixed per-name seed (CRC-32 of the name)."""
    return zlib.crc32(name.encode())


def build(name: str) -> CSR:
    """The stand-in ``name`` as a CPU CSR (see :func:`names`)."""
    if name == "hub-full":
        return _hub(build("cage11-full"), HUB_ROW_NNZ)
    if name == LONG_ROW:
        base = build("cage11-full")
        return _hub(base, base.n_cols, seed_of(LONG_ROW))
    if name in FULL:
        pattern, rows, dens, skew, seed = FULL[name]
        return random_sparse(rows, rows, dens, seed=seed, pattern=pattern,
                             skew=skew)
    for n, pattern, rows, dens, skew in SPECS:
        if n == name:
            if n == "m133-b3":
                # the paper's m133-b3 has exactly 4 nnz/row, zero variance
                rng = np.random.default_rng(7)
                r = np.repeat(np.arange(rows), 4)
                c = rng.integers(0, rows, rows * 4)
                v = rng.standard_normal(rows * 4).astype(np.float32)
                return csr_from_coo(r, c, v, (rows, rows))
            return random_sparse(rows, rows, dens, seed=seed_of(n),
                                 pattern=pattern, skew=skew or 1.5)
    raise KeyError(name)


def _hub(base: CSR, nnz: int, seed: int | None = None) -> CSR:
    """``base`` with row 0 replaced by ``nnz`` uniform random columns
    (drawn from ``seed``, default hub-full's)."""
    indptr, cols, vals = csr_to_numpy(base)
    n = base.n_rows
    rows = np.repeat(np.arange(n), np.diff(indptr))
    keep = rows != 0
    rng = np.random.default_rng(seed_of("hub-full") if seed is None else seed)
    hub_cols = rng.choice(n, nnz, replace=False)
    hub_vals = rng.standard_normal(nnz).astype(np.float32)
    return csr_from_coo(np.concatenate([np.zeros(nnz, np.int64),
                                        rows[keep]]),
                        np.concatenate([hub_cols, cols[keep]]),
                        np.concatenate([hub_vals, vals[keep]]), (n, n))


def names(full: bool = False):
    """The 13 Table III stand-ins, or with ``full`` the three
    SuiteSparse-scale ones (``LONG_ROW`` is built by name only)."""
    if full:
        return [*FULL, "hub-full"]
    return [s[0] for s in SPECS]
