"""The least-time arithmetic on a hand-counted product."""
import pytest

from perfbench import roofline


def test_least_time_hand_counted():
    # A = B: 3 x 3 with entries (0,0) (0,2) (1,1) (2,0): indptr 4 ints,
    # 4 indices, 4 values = 16 + 16 + 16 = 48 bytes.  C = A A has entries
    # (0,0) (0,2) (1,1) (2,0) (2,2): 16 + 20 + 20 = 56 bytes.  Products:
    # row 0: |row 0| + |row 2| = 3, row 1: 1, row 2: 2, so 6.
    assert roofline.csr_bytes(3, 4) == 48
    n_bytes = roofline.spgemm_bytes((3, 4), (3, 4), (3, 5))
    assert n_bytes == 48 + 48 + 56
    assert roofline.spgemm_flops(6) == 12
    t, bound = roofline.least_time(n_bytes, 12)
    assert bound == "bytes"
    assert t == pytest.approx(152 / 3.35e12)


def test_least_time_takes_the_larger_bound():
    t, bound = roofline.least_time(8, 67e12)
    assert bound == "ops" and t == pytest.approx(1.0)
