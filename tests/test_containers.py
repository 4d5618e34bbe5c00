"""Container tests: COO/CSR/CSC conversions, dense ctors, transpose —
the surface of the reference's unit_test.cu:20-64 with real assertions
(the reference's container tests assert nothing, SURVEY.md §4)."""

import numpy as np
import pytest
import scipy.sparse

from sblas.containers import (CooMatrix, CscMatrix, CsrMatrix,
                                  DenseMatrix, DenseVector, MajorOrder)
from sblas.io.generate import adversarial_skew, uniform_random
from sblas.utils import hostmath


def _random_coo(rng, m=23, n=17, nnz=60):
    r = rng.randint(0, m, nnz).astype(np.int64)
    c = rng.randint(0, n, nnz).astype(np.int64)
    v = rng.randn(nnz)
    return CooMatrix(r, c, v, (m, n))


def test_coo_sort_and_csr(rng):
    coo = _random_coo(rng)
    s = coo.sort_by_row()
    assert np.all(np.diff(s.row_idx) >= 0)
    csr = coo.to_csr()
    ref = scipy.sparse.coo_matrix(
        (coo.values, (coo.row_idx, coo.col_idx)), shape=coo.shape).tocsr()
    ref.sum_duplicates()
    np.testing.assert_allclose(csr.to_dense(), ref.toarray())
    assert csr.row_ptr[-1] == csr.nnz


def test_csr_csc_roundtrip(rng):
    csr = _random_coo(rng, 31, 29, 150).to_csr()
    csc = CscMatrix.from_csr(csr)
    assert csc.nnz == csr.nnz
    back = csc.to_csr()
    np.testing.assert_allclose(back.to_dense(), csr.to_dense())
    # CSC really is the transpose's CSR
    ref = scipy.sparse.csc_matrix(csr.to_dense())
    np.testing.assert_array_equal(csc.col_ptr, ref.indptr)
    np.testing.assert_array_equal(csc.row_idx, ref.indices)
    np.testing.assert_allclose(csc.values, ref.data)


def test_dense_ctors_deterministic():
    a = DenseMatrix.random(5, 7)
    b = DenseMatrix.random(5, 7)
    np.testing.assert_array_equal(a.values, b.values)  # seed 211 fixed
    c = DenseMatrix.constant(3, 3, 4.0)
    assert np.all(c.values == 4.0)
    v = DenseVector.random(11)
    assert v.length == 11 and np.all((v.values >= 0) & (v.values < 1))


def test_dense_transpose_flips_order():
    a = DenseMatrix.random(4, 6, order=MajorOrder.COL_MAJOR)
    t = a.transpose()
    assert t.order is MajorOrder.ROW_MAJOR
    np.testing.assert_array_equal(t.values, a.values.T)
    assert a.segment_axis == 1 and t.segment_axis == 0


def test_from_dense_nonzero_structure(rng):
    d = rng.randn(9, 9) * (rng.random_sample((9, 9)) < 0.3)
    csr = CsrMatrix.from_dense(d)
    np.testing.assert_allclose(csr.to_dense(), d)


def test_generators_shapes():
    a = uniform_random(64, 64, 4, seed=1)
    assert a.shape == (64, 64) and a.nnz <= 64 * 4
    b = adversarial_skew(m=256, n=256, heavy_rows=2, heavy_nnz=128)
    assert b.row_nnz.max() >= 100


def test_hostmath_primitives():
    rp = np.array([0, 2, 2, 5, 6])
    # find_row_of_nnz: binary-search replacement of utility.h:292-300
    np.testing.assert_array_equal(
        hostmath.find_row_of_nnz(rp, [0, 1, 2, 4, 5]), [0, 0, 2, 2, 3])
    np.testing.assert_array_equal(
        hostmath.exclusive_scan(np.array([3, 1, 4, 1])), [0, 3, 4, 8])
    out = hostmath.segmented_sum(np.array([1., 2., 3., 4.]),
                                 np.array([1, 0, 1, 0]))
    np.testing.assert_allclose(out, [3., 0., 7., 0.])
    k, v = hostmath.sort_key_value(np.array([3, 1, 2]), np.array([30, 10, 20]))
    np.testing.assert_array_equal(k, [1, 2, 3])
    np.testing.assert_array_equal(v, [10, 20, 30])


def test_shape_validation():
    from sblas.utils.errors import ShapeError
    with pytest.raises(ShapeError):
        CsrMatrix(np.zeros(3, np.int64), np.zeros(0, np.int64),
                  np.zeros(0), (5, 5))


def test_csr_transpose():
    rng = np.random.default_rng(9)
    dense = np.where(rng.random((37, 23)) < 0.15,
                     rng.standard_normal((37, 23)), 0.0)
    A = CsrMatrix.from_dense(dense)
    At = A.transpose()
    assert At.shape == (23, 37)
    np.testing.assert_array_equal(At.to_dense(), dense.T)
    # involution
    np.testing.assert_array_equal(At.transpose().to_dense(), dense)
