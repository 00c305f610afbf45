"""repro_torch formats against the JAX reference (repro.core.formats).

The same numpy-made inputs go to both packages; constructors must give
byte-equal arrays, and validation must reject the same corruptions with
the same field.  Also: the port imports neither JAX nor the JAX package.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as ref
from repro_torch.core import formats as tf
from repro_torch.data import table3

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _arrays(m):
    return [np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)]


def _port_arrays(m):
    return [t.numpy() for t in (m.indptr, m.indices, m.data)]


def _assert_same_csr(r, p):
    assert tuple(r.shape) == tuple(p.shape)
    for a, b in zip(_arrays(r), _port_arrays(p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pattern", ["uniform", "powerlaw", "banded",
                                     "blocked"])
@pytest.mark.parametrize("n_rows,n_cols,density,seed",
                         [(64, 64, 0.05, 0), (97, 41, 0.08, 3),
                          (300, 300, 0.01, 11)])
def test_random_sparse_byte_equal(pattern, n_rows, n_cols, density, seed):
    _assert_same_csr(
        ref.random_sparse(n_rows, n_cols, density, seed=seed, pattern=pattern),
        tf.random_sparse(n_rows, n_cols, density, seed=seed, pattern=pattern))


def test_csr_from_coo_sums_duplicates_like_reference():
    rng = np.random.default_rng(5)
    r = rng.integers(0, 20, 300)
    c = rng.integers(0, 15, 300)
    v = rng.standard_normal(300).astype(np.float32)
    _assert_same_csr(ref.csr_from_coo(r, c, v, (20, 15)),
                     tf.csr_from_coo(r, c, v, (20, 15)))
    _assert_same_csr(ref.csr_from_coo(r, c, v, (20, 15), nnz_cap=400),
                     tf.csr_from_coo(r, c, v, (20, 15), nnz_cap=400))
    _assert_same_csr(ref.csr_from_coo([], [], [], (4, 6)),
                     tf.csr_from_coo([], [], [], (4, 6)))


def test_csr_from_dense_and_back():
    rng = np.random.default_rng(1)
    dense = np.where(rng.random((12, 9)) < 0.3,
                     rng.standard_normal((12, 9)), 0).astype(np.float32)
    r, p = ref.csr_from_dense(dense), tf.csr_from_dense(dense)
    _assert_same_csr(r, p)
    np.testing.assert_array_equal(np.asarray(r.to_dense()),
                                  p.to_dense().numpy())
    np.testing.assert_array_equal(p.to_dense().numpy(), dense)


def test_row_ids_and_csr_to_numpy():
    m = ref.random_sparse(50, 40, 0.1, seed=2, pattern="powerlaw")
    p = tf.csr_from_numpy(*_arrays(m), m.shape)
    np.testing.assert_array_equal(
        np.asarray(ref.row_ids_from_indptr(m.indptr, m.nnz_cap + 3)),
        tf.row_ids_from_indptr(p.indptr, p.nnz_cap + 3).numpy())
    for a, b in zip(ref.csr_to_numpy(m), tf.csr_to_numpy(p)):
        np.testing.assert_array_equal(a, b)
    assert p.nnz_cap == m.nnz_cap and int(p.nnz()) == int(m.nnz())


def _corruptions(indptr, indices, data, shape):
    """(name, indptr, indices, data, shape) variants, each broken once."""
    bad_ip = indptr.copy()
    bad_ip[3], bad_ip[4] = bad_ip[4] + 1, bad_ip[3]
    yield "nonmonotonic", bad_ip, indices, data, shape
    start = indptr.copy()
    start[0] = 1
    yield "start", start, indices, data, shape
    yield "short-indptr", indptr[:-1], indices, data, shape
    over = indptr.copy()
    over[-1] = len(indices) + 1
    yield "over-capacity", over, indices, data, shape
    col = indices.copy()
    col[0] = shape[1]
    yield "column", indptr, col, data, shape
    neg = indices.copy()
    neg[1] = -1
    yield "negative-column", indptr, neg, data, shape
    nan = data.copy()
    nan[2] = np.nan
    yield "nan", indptr, indices, nan, shape
    yield "float-indices", indptr, indices.astype(np.float32), data, shape
    yield "int-data", indptr, indices, data.astype(np.int32), shape
    yield "mismatch", indptr, indices, data[:-1], shape
    yield "shape", indptr, indices, data, (0, shape[1])


def test_validate_rejects_the_same_corruptions():
    m = ref.random_sparse(16, 16, 0.2, seed=4)
    base = [a.copy() for a in _arrays(m)]
    for name, ip, ix, dt, shape in _corruptions(*base, m.shape):
        r = ref.CSR(jnp.asarray(ip), jnp.asarray(ix), jnp.asarray(dt), shape)
        p = tf.CSR(torch.from_numpy(ip), torch.from_numpy(ix),
                   torch.from_numpy(dt), shape)
        with pytest.raises(ref.InvalidOperand) as want:
            ref.validate_csr(r, "A")
        with pytest.raises(tf.InvalidOperand) as got:
            tf.validate_csr(p, "A")
        assert got.value.field == want.value.field, name
        assert str(got.value) == str(want.value), name
    ok = tf.csr_from_numpy(*base, m.shape)
    tf.validate_csr(ok)
    with pytest.raises(tf.InvalidOperand, match="inner dims"):
        tf.validate_operands(ok, tf.random_sparse(15, 4, 0.3, seed=0))


def test_csr_move_keeps_dtypes():
    p = tf.random_sparse(10, 10, 0.2, seed=0)
    assert p.to("cpu") is p
    assert (p.indptr.dtype, p.indices.dtype, p.data.dtype) == \
        (torch.int32, torch.int32, torch.float32)


def test_table3_is_deterministic_and_complete():
    assert len(table3.names()) == 13
    assert table3.names(full=True) == ["cage11-full", "email-Enron-full",
                                       "hub-full"]
    for name in ("p2p", "m133-b3"):
        a, b = table3.build(name), table3.build(name)
        for x, y in zip(_port_arrays(a), _port_arrays(b)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(KeyError):
        table3.build("nope")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
