"""The PyTorch reference and its bfloat16 control against dense products."""
import numpy as np
import pytest

from perfbench import generate
from perfbench.reference import spgemm as ref


def _csr(dense):
    r, c = np.nonzero(dense)
    indptr = np.zeros(dense.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=dense.shape[0]), out=indptr[1:])
    return indptr, c.astype(np.int32), dense[r, c].astype(np.float32)


def _dense(indptr, indices, data, shape):
    out = np.zeros(shape)
    rows = np.repeat(np.arange(shape[0]), np.diff(indptr))
    out[rows, indices] = data
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(40, 30, 50), (64, 64, 64), (1, 7, 3)])
def test_reference_matches_dense_product(seed, shape):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, k)) < 0.2) * rng.standard_normal((m, k))
         ).astype(np.float32)
    b = ((rng.random((k, n)) < 0.2) * rng.standard_normal((k, n))
         ).astype(np.float32)
    indptr, indices, data, scale = ref.spgemm(_csr(a), _csr(b), n)
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(_dense(indptr, indices, data, (m, n)), want,
                               rtol=1e-12, atol=1e-12)
    # every entry with a product, a cancelled one too
    assert np.count_nonzero(np.abs(a) @ np.abs(b)) == len(indices)
    np.testing.assert_allclose(
        _dense(indptr, indices, scale, (m, n)),
        np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)),
        rtol=1e-12)
    # columns ascend within each row
    rows = np.repeat(np.arange(m), np.diff(indptr))
    assert np.all(np.diff(rows * n + indices) > 0)


def test_reference_keeps_cancelled_entries():
    a = np.array([[1.0, 1.0], [0.0, 2.0]], np.float32)
    b = np.array([[3.0, 1.0], [-3.0, 0.0]], np.float32)
    indptr, indices, data, scale = ref.spgemm(_csr(a), _csr(b), 2)
    # C = [[0, 1], [-6, 0]]: the cancelled (0, 0) is an entry with a
    # product, its sum 0 beside its scale
    assert indptr.tolist() == [0, 2, 3]
    assert indices.tolist() == [0, 1, 0]
    assert data.tolist() == [0.0, 1.0, -6.0]
    assert scale.tolist() == [6.0, 1.0, 6.0]
    # the control drops it, as the program does
    indptr, indices, data = ref.spgemm_bf16(_csr(a), _csr(b), 2)
    assert indptr.tolist() == [0, 1, 2] and indices.tolist() == [1, 0]


def test_a_cancelled_entry_may_be_dropped_a_real_one_may_not():
    from perfbench import compare
    a = np.array([[1.0, 1.0], [0.0, 2.0]], np.float32)
    b = np.array([[3.0, 1.0], [-3.0, 0.0]], np.float32)
    want = ref.spgemm(_csr(a), _csr(b), 2)
    dropped = (np.array([0, 1, 2]), np.array([1, 0], np.int32),
               np.array([1.0, -6.0], np.float32))
    assert compare.compare(dropped, want, 2) == {"structure": 0,
                                                  "value_err": 0.0}
    lost = (np.array([0, 1, 1]), np.array([1], np.int32),
            np.array([1.0], np.float32))
    got = compare.compare(lost, want, 2)
    assert got["structure"] == 0 and got["value_err"] == 1.0
    extra = (np.array([0, 1, 3]), np.array([1, 0, 1], np.int32),
             np.array([1.0, -6.0, 2.0], np.float32))
    assert compare.compare(extra, want, 2)["structure"] == 1
    # an entry kept with its rounding is right, one with a wrong value not
    kept = (np.array([0, 2, 3]), np.array([0, 1, 0], np.int32),
            np.array([1e-9, 1.0, -6.0], np.float32))
    assert compare.passes(compare.compare(kept, want, 2))
    wrong = (np.array([0, 2, 3]), np.array([0, 1, 0], np.int32),
             np.array([0.5, 1.0, -6.0], np.float32))
    assert not compare.passes(compare.compare(wrong, want, 2))


def test_to_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -9,
                  -2.5, 0.0], np.float32)
    got = ref.to_bf16(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -6, 1.0, -2.5, 0.0]


def test_bf16_control_is_a_product_in_bf16():
    rng = np.random.default_rng(3)
    a = ((rng.random((30, 30)) < 0.3) * rng.standard_normal((30, 30))
         ).astype(np.float32)
    indptr, indices, data = ref.spgemm_bf16(_csr(a), _csr(a), 30)
    assert np.array_equal(ref.to_bf16(data), data)
    want = a.astype(np.float64) @ a.astype(np.float64)
    got = _dense(indptr, indices, data, (30, 30))
    scale = np.abs(a.astype(np.float64)) @ np.abs(a.astype(np.float64))
    err = np.abs(got - want)[scale > 0] / scale[scale > 0]
    assert err.max() < 2 ** -6          # within bfloat16's reach
    assert err.max() > 1e-4             # and far from float32's


@pytest.mark.parametrize("name", ["hpcg-40", "enron-standin"])
def test_reference_of_a_generated_draw_has_the_configured_work(name):
    from conftest import small_config
    cfg = small_config(name)
    lane = generate.draw(cfg, 5)
    indptr, indices, _, _ = ref.spgemm(lane, lane, cfg["cols"])
    work = generate.row_work(lane[0], lane[1], lane[0])
    assert indptr[-1] == len(indices) <= work.sum()
    assert np.all((np.diff(indptr) > 0) <= (work > 0))


def test_an_entry_of_zero_products_agrees_where_it_reads_zero():
    from perfbench import compare
    a = np.array([[0.0, 1.0], [2.0, 0.0]], np.float32)
    a_csr = (np.array([0, 2, 3]), np.array([0, 1, 0], np.int32),
             np.array([0.0, 1.0, 2.0], np.float32))   # an explicit zero
    want = ref.spgemm(a_csr, a_csr, 2)
    # C = [[2, 0], [0, 2]]; (0, 0) = 0*0 + 1*2, (1, 0) = 2*0: scale 0
    assert want[3].min() == 0.0
    dropped = _csr(a.astype(np.float64) @ a.astype(np.float64))
    assert compare.compare(dropped, want, 2) == {"structure": 0,
                                                  "value_err": 0.0}
    wrong = (np.array([0, 2, 3]), np.array([0, 1, 0], np.int32),
             np.array([2.0, 1.0, 5.0], np.float32))
    assert not compare.passes(compare.compare(wrong, want, 2))
