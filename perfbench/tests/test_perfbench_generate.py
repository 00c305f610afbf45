"""The generators: one draw per seed, the same work from every seed, and
the full-size patterns as their configurations state them."""
import json

import numpy as np
import pytest
from conftest import ROOT, small_config

from perfbench import generate, harness
from perfbench.reference import spgemm as ref

SEEDS = [0, 7, 2 ** 31 + 17, 2 ** 33 + 5, -3]
NAMES = ["hpcg-40", "enron-standin"]


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_draw(name, seed):
    cfg = small_config(name)
    a, b = generate.draw(cfg, seed), generate.draw(cfg, seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a[0].dtype == np.int32 and a[1].dtype == np.int32
    assert a[2].dtype == np.float32


@pytest.mark.parametrize("name", NAMES)
def test_every_seed_gives_the_same_work(name):
    cfg = small_config(name)
    draws = [generate.draw(cfg, s) for s in SEEDS]
    works = [np.sort(generate.row_work(d[0], d[1], d[0])) for d in draws]
    nnz_c = [len(ref.spgemm(d, d, cfg["cols"])[1]) for d in draws]
    for w in works[1:]:
        assert np.array_equal(w, works[0])
    assert len(set(nnz_c)) == 1
    # the values differ, and the rows' order where the configuration
    # permutes them
    assert not np.array_equal(draws[0][2], draws[1][2])
    assert np.array_equal(draws[0][1], draws[1][1]) == (not cfg["permute"])


def test_lanes_are_independent_draws():
    cfg = small_config("enron-standin")
    lanes = harness.make_inputs(cfg, {"lanes": 4}, 9)
    assert len(lanes) == 4
    assert len({lane[2][:8].tobytes() for lane in lanes}) == 4


def test_stencil_is_hpcgs():
    """Every grid point's row holds the points one step away or less in
    each direction, inside the grid, in ascending order."""
    nx, ny, nz = 3, 4, 5
    cfg = {"pattern": "stencil27", "nx": nx, "ny": ny, "nz": nz,
           "rows": nx * ny * nz, "cols": nx * ny * nz}
    indptr, indices = generate.pattern(cfg)
    pts = [(x, y, z) for z in range(nz) for y in range(ny) for x in range(nx)]
    for r, (x, y, z) in enumerate(pts):
        want = sorted(j for j, (a, b, c) in enumerate(pts)
                      if max(abs(a - x), abs(b - y), abs(c - z)) <= 1)
        assert list(indices[indptr[r]:indptr[r + 1]]) == want


def test_configuration_model_is_a_simple_graph():
    cfg = small_config("enron-standin", rows=3000)
    indptr, indices = generate.pattern(cfg)
    n = cfg["rows"]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    dense = np.zeros((n, n), bool)
    dense[rows, indices] = True
    assert (dense == dense.T).all() and not dense.diagonal().any()
    assert len(indices) == dense.sum()          # no entry twice
    deg = np.diff(indptr)
    assert deg.min() >= 1 and deg.max() <= round(cfg["degree_head"])


@pytest.mark.parametrize("name", NAMES)
def test_full_size_pattern_is_as_stated(name):
    """The full-size configurations draw the patterns whose statistics
    their files state."""
    cfg = _config(name)
    indptr, indices = generate.pattern(cfg)
    deg = np.diff(indptr).astype(np.int64)
    st = cfg["stats"]
    assert len(indptr) - 1 == cfg["rows"]
    assert generate.row_work(indptr, indices, indptr).sum() == \
        st["products"]
    if name == "hpcg-40":
        assert len(indices) == cfg["nnz"]
        assert (deg == 27).sum() == st["rows_27_entries"]
    else:
        assert len(indices) == st["nnz"]
        assert deg.max() == st["max_degree"] and deg.min() == st["min_degree"]
        assert (deg * (deg - 1) // 2).sum() == st["wedges"]
