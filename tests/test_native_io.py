"""Native C++ .mtx parser: parity with the pure-numpy path and perf sanity.

The native tier must produce byte-identical triplets to the numpy parser on
every field/symmetry combination; it is allowed to be absent (tests skip)."""

import os
import time

import numpy as np
import pytest

from sblas.io import mmio, native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

REFERENCE_ASH85 = "/root/reference/ash85.mtx"


def _roundtrip_case(tmp_path, field, symmetry, n=50, nnz=200, seed=5):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, n, nnz).astype(np.int64)
    c = rng.randint(0, n, nnz).astype(np.int64)
    if symmetry != "general":
        r, c = np.maximum(r, c), np.minimum(r, c)  # lower triangle
        if symmetry == "skew-symmetric":
            off = r != c
            r, c = r[off], c[off]
    if field == "complex":
        v = rng.randn(len(r)) + 1j * rng.randn(len(r))
    elif field == "integer":
        v = rng.randint(-50, 50, len(r))
    else:
        v = rng.randn(len(r)) * 10.0 ** rng.randint(-30, 30, len(r))
    p = str(tmp_path / f"{field}_{symmetry}.mtx")
    mmio.write_mtx(p, n, n, r, c, v, field=field, symmetry=symmetry)
    return p


@pytest.mark.parametrize("field", ["real", "integer", "pattern", "complex"])
@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
def test_native_matches_numpy(tmp_path, field, symmetry, monkeypatch):
    if field == "pattern" and symmetry == "skew-symmetric":
        pytest.skip("patterns have no sign to skew")
    p = _roundtrip_case(tmp_path, field, symmetry)
    dtype = np.complex128 if field == "complex" else np.float64
    h1, r1, c1, v1 = mmio.read_coo(p, value_dtype=dtype)
    monkeypatch.setenv("SBLAS_NO_NATIVE", "1")
    h2, r2, c2, v2 = mmio.read_coo(p, value_dtype=dtype)
    assert h1 == h2
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(v1, v2)  # bit-identical


@pytest.mark.skipif(not os.path.exists(REFERENCE_ASH85),
                    reason="reference fixture not mounted")
def test_native_ash85_identical(monkeypatch):
    h1, r1, c1, v1 = mmio.read_coo(REFERENCE_ASH85)
    monkeypatch.setenv("SBLAS_NO_NATIVE", "1")
    h2, r2, c2, v2 = mmio.read_coo(REFERENCE_ASH85)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(v1, v2)


def test_native_speedup_on_large_file(tmp_path):
    """The native tier exists for speed; hold it to at least parity on a
    ~200k-entry file (it is typically 5-10x faster)."""
    rng = np.random.RandomState(1)
    nnz, n = 200_000, 50_000
    p = str(tmp_path / "big.mtx")
    mmio.write_mtx(p, n, n, rng.randint(0, n, nnz), rng.randint(0, n, nnz),
                   rng.randn(nnz))

    t0 = time.perf_counter()
    _, r1, c1, v1 = mmio.read_coo(p)
    t_native = time.perf_counter() - t0

    os.environ["SBLAS_NO_NATIVE"] = "1"
    try:
        t0 = time.perf_counter()
        _, r2, c2, v2 = mmio.read_coo(p)
        t_numpy = time.perf_counter() - t0
    finally:
        del os.environ["SBLAS_NO_NATIVE"]

    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(v1, v2)
    assert t_native <= t_numpy * 1.5, (t_native, t_numpy)


def test_native_malformed_falls_back(tmp_path):
    """Truncated data: native parser reports failure; mmio must still raise
    the same FormatError as the numpy path (via fallback)."""
    p = tmp_path / "trunc.mtx"
    p.write_text("%%MatrixMarket matrix coordinate real general\n"
                 "3 3 3\n1 1 1.0\n")
    from sblas.utils.errors import FormatError
    with pytest.raises(FormatError):
        mmio.read_coo(str(p))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64, np.int8])
def test_native_scatter_bucketed_matches_numpy(dtype):
    """Exercise the radix-bucketed branch of native.scatter (only engages
    above 2^18 elements), including duplicate addresses: the bucketing is
    stable within buckets so numpy's last-write-wins order must hold."""
    from sblas.io import native
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(3)
    n_out = 1 << 19
    ne = n_out + 1024  # > n_out forces duplicates
    addr = rng.randint(0, n_out, ne).astype(np.int32)
    vals = (rng.randn(ne) * 100).astype(dtype)
    expect = np.zeros(n_out, dtype=dtype)
    expect[addr] = vals
    got = native.scatter(np.zeros(n_out, dtype=dtype), addr, vals)
    np.testing.assert_array_equal(got, expect)


def test_native_scatter_scalar_broadcast():
    """Scalar vals broadcast across all addresses (used by the planners to
    flag-fill)."""
    from sblas.io import native
    out = np.zeros(1000, dtype=np.int32)
    native.scatter(out, np.array([3, 997], dtype=np.int32), 7)
    assert out[3] == 7 and out[997] == 7 and out.sum() == 14
