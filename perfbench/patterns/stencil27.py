"""HPCG's matrix: the 27-point stencil on an ``nx`` x ``ny`` x ``nz`` grid.

Row ``ix + nx (iy + ny iz)`` holds the grid point and every neighbour that
differs by at most one step in each direction and lies inside the grid:
27 entries inside, 8 at a corner (``GenerateProblem`` of the HPCG
reference code).  HPCG's values (26 on the diagonal, -1 off it) are not
kept: the run draws its own from the seed.
"""
import numpy as np


def pattern(cfg):
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    n = nx * ny * nz
    if (int(cfg["rows"]), int(cfg["cols"])) != (n, n):
        raise ValueError(f"rows and cols must be nx*ny*nz = {n}")
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    cols, inside = [], []
    # (sz, sy, sx) in lexicographic order: each row's columns ascend
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                jx, jy, jz = ix + sx, iy + sy, iz + sz
                inside.append((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                              & (jz >= 0) & (jz < nz))
                cols.append(jx + nx * (jy + ny * jz))
    cols, inside = np.stack(cols, 1), np.stack(inside, 1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(inside.sum(1), out=indptr[1:])
    return indptr.astype(np.int32), cols[inside].astype(np.int32)
