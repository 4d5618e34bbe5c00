"""Windowed-COO plan tests: tiling invariants, window splits on empty-row
gaps, SpMV/SpMM parity with the CPU oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import CooMatrix, CsrMatrix, DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops import WcooPlan, make_plan, spmm, spmv
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.ops.wcoo import TILE, WINDOW, spmm_wcoo, spmv_wcoo


def _gappy_matrix(seed=3):
    """nnz separated by large empty-row gaps: forces tile splits."""
    rng = np.random.RandomState(seed)
    m = 10_000
    rows = np.sort(rng.choice(m, size=60, replace=False)).astype(np.int64)
    cols = rng.randint(0, m, size=60).astype(np.int64)
    vals = rng.randn(60)
    return CooMatrix(rows, cols, vals, (m, m)).to_csr()


MATRICES = {
    "web": lambda: webbase_like(n=2000, avg_deg=3.0),
    "uniform": lambda: uniform_random(300, 250, 4, seed=5),
    "skew": lambda: adversarial_skew(m=256, n=200, heavy_rows=2,
                                     heavy_nnz=300, light_nnz=1),
    "banded": lambda: fem_banded_like(n=500, half_band=3),
    "gappy": _gappy_matrix,
    "single": lambda: uniform_random(1, 1, 1, seed=1),
}


@pytest.fixture(params=sorted(MATRICES))
def A(request):
    return MATRICES[request.param]()


def test_plan_invariants(A):
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    assert plan.vals.shape[0] == plan.n_tiles * TILE
    assert plan.cols.shape == plan.rows.shape == plan.vals.shape
    # values preserved
    np.testing.assert_allclose(np.sort(np.asarray(plan.vals)[
        np.asarray(plan.vals) != 0]), np.sort(A.values[A.values != 0]))
    # every tile's rows lie in one 128-aligned window of depth WINDOW,
    # and window starts are monotone in tile order
    rows = np.asarray(plan.rows).reshape(plan.n_tiles, TILE)
    start = rows.min(axis=1) // 128 * 128
    assert np.all(rows - start[:, None] < WINDOW)
    assert np.all(np.diff(start) >= 0)
    assert rows.min() >= 0 and rows.max() < max(A.shape[0], 1)
    assert np.asarray(plan.cols).max(initial=0) < max(A.shape[1], 1)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (3.0, 4.0)])
def test_spmv_wcoo_matches_oracle(A, alpha, beta):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    got = spmv_wcoo(plan, jnp.asarray(x.values), alpha, beta,
                    jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, alpha, beta, y))


def test_spmm_wcoo_matches_oracle(A):
    B = DenseMatrix.random(A.width, 24)
    C = DenseMatrix.constant(A.height, 24, 1.0)
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    got = spmm_wcoo(plan, jnp.asarray(B.values), 3.0, 4.0,
                    jnp.asarray(C.values), k_chunk=4)
    assert_equal(np.asarray(got), spmm_cpu(A, B, 3.0, 4.0, C))


def test_gappy_splits_tiles():
    A = _gappy_matrix()
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    # 60 nnz scattered over 10k rows: nearly every nnz needs its own window
    assert plan.n_tiles > 10
    assert plan.fill_ratio > 8  # pathological fill for this layout
    # (for this matrix the heuristic legitimately picks ELL: L=1)


def test_fill_limit_falls_back_to_coo():
    """Skewed + gappy: ELL rejected (row imbalance), windowed-COO rejected
    (fill blowup) -> plain COO fallback."""
    rng = np.random.RandomState(4)
    m = 20_000
    rows = np.sort(rng.choice(m, size=60, replace=False)).astype(np.int64)
    heavy = np.full(200, rows[0], dtype=np.int64)
    all_rows = np.sort(np.concatenate([rows, heavy]))
    cols = rng.randint(0, m, size=len(all_rows)).astype(np.int64)
    A = CooMatrix(all_rows, cols, rng.randn(len(all_rows)), (m, m)).to_csr()
    from sblas.ops import CooPlan
    assert isinstance(make_plan(A, dtype=jnp.float64), CooPlan)


def test_heuristic_picks_wcoo_for_powerlaw():
    web = webbase_like(n=3000, avg_deg=3.0)
    assert isinstance(make_plan(web, dtype=jnp.float64), WcooPlan)


def test_dispatcher_routes_wcoo():
    A = webbase_like(n=1500, avg_deg=3.0)
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    x = DenseVector.random(A.width)
    got = spmv(plan, jnp.asarray(x.values), 2.0)
    want = spmv_cpu(A, x, 2.0, 0.0, DenseVector.constant(A.height, 0.0))
    assert_equal(np.asarray(got), want)
    B = DenseMatrix.random(A.width, 8)
    got_m = spmm(plan, jnp.asarray(B.values), 2.0)
    want_m = spmm_cpu(A, B, 2.0, 0.0, DenseMatrix.constant(A.height, 8, 0.0))
    assert_equal(np.asarray(got_m), want_m)


def test_empty_matrix():
    A = CsrMatrix(np.zeros(11, np.int64), np.zeros(0, np.int64),
                  np.zeros(0), (10, 10))
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    x = DenseVector.constant(10, 1.0)
    y = DenseVector.constant(10, 2.0)
    got = spmv_wcoo(plan, jnp.asarray(x.values), 3.0, 4.0,
                    jnp.asarray(y.values))
    np.testing.assert_allclose(np.asarray(got), 8.0)


def test_fused_reduce_accumulation_runs():
    """Many tiles per window: the reduce must accumulate every tile that
    maps to one output block (small fixtures often have one tile per
    window and never exercise that)."""
    from sblas.containers import CooMatrix
    rng = np.random.RandomState(3)
    m, n, k = 256, 2048, 16
    # all nnz inside rows [0, 128): ~40 tiles, all in one window
    rows = rng.randint(0, 128, size=5000).astype(np.int64)
    cols = rng.randint(0, n, size=5000).astype(np.int64)
    vals = rng.random_sample(5000)
    A = CooMatrix(rows, cols, vals, (m, n)).to_csr()
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    assert plan.n_tiles > 3  # multiple tiles share the single window
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    got = spmm_wcoo(plan, jnp.asarray(B.values), 2.0, 3.0,
                    jnp.asarray(C.values))
    assert_equal(np.asarray(got), spmm_cpu(A, B, 2.0, 3.0, C))


def test_fused_reduce_with_min_tiles_padding():
    """Pad tiles (shared static dims in distributed/UM plans) anchor at
    the last real window and add nothing."""
    A = uniform_random(512, 512, nnz_per_row=4, seed=6, dtype=np.float64)
    base = WcooPlan.from_csr(A, dtype=jnp.float64)
    padded = WcooPlan.from_csr(A, dtype=jnp.float64,
                               min_tiles=base.n_tiles + 7)
    B = DenseMatrix.random(A.width, 8)
    C = DenseMatrix.constant(A.height, 8, 1.0)
    a = spmm_wcoo(base, jnp.asarray(B.values), 2.0, 3.0,
                  jnp.asarray(C.values))
    b = spmm_wcoo(padded, jnp.asarray(B.values), 2.0, 3.0,
                  jnp.asarray(C.values))
    assert_equal(np.asarray(b), spmm_cpu(A, B, 2.0, 3.0, C))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)



@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_wcoo_f32_relative_bar(op):
    """float32 plans meet the reference's 1e-3 bar (relative, as for
    every f32 check) on a power-law matrix, whose long rows make the
    summation order matter most."""
    A = webbase_like(n=3000, avg_deg=6.0, dtype=np.float32)
    plan = WcooPlan.from_csr(A, dtype=jnp.float32)
    if op == "spmv":
        x = DenseVector.random(A.width, dtype=np.float32)
        y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
        got = spmv_wcoo(plan, jnp.asarray(x.values), 3.0, 4.0,
                        jnp.asarray(y.values))
        want = spmv_cpu(A, x, 3.0, 4.0, y)
    else:
        B = DenseMatrix.random(A.width, 16, dtype=np.float32)
        C = DenseMatrix.constant(A.height, 16, 1.0, dtype=np.float32)
        got = spmm_wcoo(plan, jnp.asarray(B.values), 3.0, 4.0,
                        jnp.asarray(C.values))
        want = spmm_cpu(A, B, 3.0, 4.0, C)
    assert got.dtype == jnp.float32
    assert_equal(np.asarray(got), want, relative=True)
