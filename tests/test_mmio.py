"""Matrix-Market I/O tests: banner/typecode semantics, symmetric expansion,
pattern values, round-trip, scipy cross-check (SURVEY.md §7 design mapping)."""

import os

import numpy as np
import pytest
import scipy.io
import scipy.sparse

from sblas.io import mmio
from sblas.containers import CooMatrix, CsrMatrix
from sblas.utils.errors import FormatError

REFERENCE_ASH85 = "/root/reference/ash85.mtx"


def _write(tmp_path, text, name="m.mtx"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_header_parse(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate real general\n"
                         "% a comment\n\n"
                         "3 4 2\n1 1 5.0\n3 4 -2.5\n")
    h = mmio.read_header(p)
    assert (h.nrows, h.ncols, h.nnz_stored) == (3, 4, 2)
    assert h.is_sparse and not h.is_pattern and h.is_general


def test_bad_banner(tmp_path):
    p = _write(tmp_path, "%%NotMatrixMarket nope\n1 1 1\n1 1 1.0\n")
    with pytest.raises(FormatError):
        mmio.read_header(p)


def test_general_real(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate real general\n"
                         "3 4 2\n1 1 5.0\n3 4 -2.5\n")
    h, r, c, v = mmio.read_coo(p)
    np.testing.assert_array_equal(r, [0, 2])
    np.testing.assert_array_equal(c, [0, 3])
    np.testing.assert_allclose(v, [5.0, -2.5])


def test_symmetric_expansion(tmp_path):
    """Off-diagonals mirrored, diagonal stored once (mmio_highlevel.h:95-100,
    242-263 semantics)."""
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate real symmetric\n"
                         "3 3 3\n1 1 1.0\n2 1 2.0\n3 2 3.0\n")
    csr = CsrMatrix.from_mtx(p)
    dense = csr.to_dense()
    expect = np.array([[1, 2, 0], [2, 0, 3], [0, 3, 0]], dtype=float)
    np.testing.assert_allclose(dense, expect)
    assert csr.nnz == 5  # 1 diagonal + 2*2 mirrored


def test_skew_symmetric(tmp_path):
    p = _write(tmp_path,
               "%%MatrixMarket matrix coordinate real skew-symmetric\n"
               "3 3 2\n2 1 2.0\n3 2 3.0\n")
    dense = CsrMatrix.from_mtx(p).to_dense()
    expect = np.array([[0, -2, 0], [2, 0, -3], [0, 3, 0]], dtype=float)
    np.testing.assert_allclose(dense, expect)


def test_pattern_values_are_one(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate pattern general\n"
                         "2 2 2\n1 2\n2 1\n")
    h, r, c, v = mmio.read_coo(p)
    assert h.is_pattern
    np.testing.assert_allclose(v, [1.0, 1.0])


def test_complex_real_part(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate complex general\n"
                         "2 2 1\n1 2 3.5 -1.0\n")
    _, _, _, v = mmio.read_coo(p, value_dtype=np.float64)
    np.testing.assert_allclose(v, [3.5])
    _, _, _, vc = mmio.read_coo(p, value_dtype=np.complex128)
    np.testing.assert_allclose(vc, [3.5 - 1.0j])


def test_integer_field(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate integer general\n"
                         "2 2 2\n1 1 7\n2 2 -3\n")
    _, _, _, v = mmio.read_coo(p)
    np.testing.assert_allclose(v, [7.0, -3.0])


def test_array_format(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix array real general\n"
                         "2 2\n1\n2\n3\n4\n")
    dense = CsrMatrix.from_mtx(p).to_dense()
    # array data is column-major
    np.testing.assert_allclose(dense, [[1, 3], [2, 4]])


def test_array_symmetric(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix array real symmetric\n"
                         "2 2\n1\n2\n4\n")
    dense = CsrMatrix.from_mtx(p).to_dense()
    np.testing.assert_allclose(dense, [[1, 2], [2, 4]])


def test_duplicates_summed(tmp_path):
    p = _write(tmp_path, "%%MatrixMarket matrix coordinate real general\n"
                         "2 2 3\n1 1 1.0\n1 1 2.0\n2 2 5.0\n")
    csr = CsrMatrix.from_mtx(p)
    assert csr.nnz == 2
    np.testing.assert_allclose(csr.to_dense(), [[3, 0], [0, 5]])


def test_roundtrip_write_read(tmp_path):
    rng = np.random.RandomState(3)
    r = rng.randint(0, 10, 30).astype(np.int64)
    c = rng.randint(0, 8, 30).astype(np.int64)
    v = rng.randn(30)
    p = str(tmp_path / "rt.mtx")
    mmio.write_mtx(p, 10, 8, r, c, v, comment="roundtrip")
    h, r2, c2, v2 = mmio.read_coo(p)
    assert (h.nrows, h.ncols) == (10, 8)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(c, c2)
    np.testing.assert_allclose(v, v2)


@pytest.mark.skipif(not os.path.exists(REFERENCE_ASH85),
                    reason="reference fixture not mounted")
def test_ash85_matches_scipy():
    """Cross-check our loader against scipy.io.mmread on the reference's own
    fixture (85x85 pattern symmetric, 304 stored entries -> 523 nnz after
    expansion: 304*2 - 85 diagonal... actual count asserted vs scipy)."""
    ours = CsrMatrix.from_mtx(REFERENCE_ASH85)
    theirs = scipy.io.mmread(REFERENCE_ASH85).tocsr()
    assert ours.shape == theirs.shape
    assert ours.nnz == theirs.nnz
    np.testing.assert_allclose(ours.to_dense(), theirs.toarray())


@pytest.mark.skipif(not os.path.exists(REFERENCE_ASH85),
                    reason="reference fixture not mounted")
def test_ash85_coo_loader_handles_pattern():
    """The framework's COO loader must apply full MM semantics — fixing the
    reference quirk where CooSparseMatrix's fscanf loader reads garbage
    values for pattern files (matrix.h:169-176)."""
    coo = CooMatrix.from_mtx(REFERENCE_ASH85)
    assert np.all(coo.values == 1.0)
    assert coo.to_csr().nnz == scipy.io.mmread(REFERENCE_ASH85).tocsr().nnz


def test_lexsort2_matches_lexsort():
    """Composite-key sort (utils/hostmath.lexsort2) must reproduce
    np.lexsort exactly: stable, primary-major, duplicate-heavy inputs,
    empty input, and the huge-range fallback path."""
    import numpy as np

    from sblas.utils.hostmath import lexsort2

    rng = np.random.RandomState(0)
    for n, hi in ((0, 10), (1, 1), (1000, 7), (10000, 1000)):
        p = rng.randint(0, hi, size=n).astype(np.int64)
        s = rng.randint(0, hi, size=n).astype(np.int64)
        np.testing.assert_array_equal(lexsort2(s, p), np.lexsort((s, p)))
    # key overflow range: falls back to lexsort, same result
    p = rng.randint(0, 2**40, size=1000).astype(np.int64)
    s = rng.randint(0, 2**40, size=1000).astype(np.int64)
    np.testing.assert_array_equal(lexsort2(s, p), np.lexsort((s, p)))


def test_skew_symmetric_array_file(tmp_path):
    """Skew-symmetric ARRAY files store only the strict lower triangle
    (the diagonal is identically zero, MM spec); the reader previously
    rejected every such file with a length mismatch."""
    import numpy as np

    from sblas.io.mmio import read_coo

    p = tmp_path / "skew.mtx"
    p.write_text("%%MatrixMarket matrix array real skew-symmetric\n"
                 "3 3\n1.0\n2.0\n3.0\n")
    _, r, c, v = read_coo(str(p))
    d = np.zeros((3, 3))
    d[r, c] = v
    want = np.array([[0., -1., -2.], [1., 0., -3.], [2., 3., 0.]])
    np.testing.assert_array_equal(d, want)
