"""Single-chip SpMV/SpMM kernel tests vs the CPU oracle at the reference's
1e-3 absolute tolerance (utility.h:182-193, config.h:21), on ash85 and
synthetic matrices including adversarial skew."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import CsrMatrix, DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops import (CooPlan, EllPlan, axpby, make_plan, plus_scalar,
                           spmm, spmv)
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.ops.spmm import spmm_coo, spmm_ell


def _operands_vec(A, fill=1.0):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, fill)
    return x, y


def _operands_mat(A, k=8, fill=1.0):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, fill)
    return B, C


MATRICES = {
    "uniform": lambda: uniform_random(100, 80, 5, seed=3),
    "skew": lambda: adversarial_skew(m=128, n=96, heavy_rows=2,
                                     heavy_nnz=64, light_nnz=1),
    "banded": lambda: fem_banded_like(n=200, half_band=4),
    "tiny_web": lambda: webbase_like(n=500, avg_deg=3.0),
}


@pytest.fixture(params=sorted(MATRICES))
def matrix(request):
    return MATRICES[request.param]()


@pytest.mark.parametrize("kind", ["coo", "ell"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (3.0, 4.0), (2.5, 0.0)])
def test_spmv_matches_oracle(matrix, kind, alpha, beta):
    A = matrix
    x, y = _operands_vec(A)
    plan = make_plan(A, dtype=jnp.float64, force=kind)
    got = spmv(plan, jnp.asarray(x.values), alpha, beta,
               jnp.asarray(y.values))
    want = spmv_cpu(A, x, alpha, beta, y)
    assert_equal(np.asarray(got), want)


@pytest.mark.parametrize("kind", ["coo", "ell"])
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (3.0, 4.0)])
def test_spmm_matches_oracle(matrix, kind, alpha, beta):
    A = matrix
    B, C = _operands_mat(A, k=8)
    plan = make_plan(A, dtype=jnp.float64, force=kind)
    got = spmm(plan, jnp.asarray(B.values), alpha, beta,
               jnp.asarray(C.values))
    want = spmm_cpu(A, B, alpha, beta, C)
    assert_equal(np.asarray(got), want)


def test_spmv_ash85(ash85):
    """The reference's spmvCsrTest shape: ash85, alpha=3, beta=4
    (unit_test.cu:139-175)."""
    x, y = _operands_vec(ash85)
    for kind in ("coo", "ell"):
        plan = make_plan(ash85, dtype=jnp.float64, force=kind)
        got = spmv(plan, jnp.asarray(x.values), 3.0, 4.0,
                   jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(ash85, x, 3.0, 4.0, y))


def test_spmm_ash85_k256(ash85):
    """The reference's spmmCsrTest shape: ash85, K=256, alpha=3, beta=4
    (unit_test.cu:66-98)."""
    B, C = _operands_mat(ash85, k=256)
    plan = make_plan(ash85, dtype=jnp.float64)
    got = spmm(plan, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values))
    assert_equal(np.asarray(got), spmm_cpu(ash85, B, 3.0, 4.0, C))


def test_spmm_coo_chunked_equals_unchunked():
    A = uniform_random(64, 64, 6, seed=5)
    B, C = _operands_mat(A, k=16)
    plan = CooPlan.from_csr(A, dtype=jnp.float64)
    full = spmm_coo(plan, jnp.asarray(B.values), 1.5, 0.5,
                    jnp.asarray(C.values), n_chunks=1)
    chunked = spmm_coo(plan, jnp.asarray(B.values), 1.5, 0.5,
                       jnp.asarray(C.values), n_chunks=4)
    np.testing.assert_allclose(np.asarray(full), np.asarray(chunked),
                               rtol=1e-12)


def test_spmm_ell_k_chunking():
    A = uniform_random(40, 40, 7, seed=9)
    B, C = _operands_mat(A, k=8)
    plan = EllPlan.from_csr(A, dtype=jnp.float64)
    a = spmm_ell(plan, jnp.asarray(B.values), 1.0, 1.0,
                 jnp.asarray(C.values), k_chunk=3)
    b = spmm_ell(plan, jnp.asarray(B.values), 1.0, 1.0,
                 jnp.asarray(C.values), k_chunk=8)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_plan_heuristic():
    from sblas.ops import BsrPlan, WcooPlan

    # tiny (one-block) matrices go dense outright (blowup ratios are
    # meaningless at kilobyte scale)
    assert isinstance(make_plan(uniform_random(64, 64, 4, seed=2),
                                dtype=jnp.float64), BsrPlan)
    # balanced low-degree rows at a scale where BELL padding blows up:
    # the ELL branch
    assert isinstance(make_plan(uniform_random(5000, 5000, 4, seed=2),
                                dtype=jnp.float64), EllPlan)
    # heavy skew defeats ELL; windowed-COO absorbs it with ~1x fill
    assert isinstance(make_plan(adversarial_skew(), dtype=jnp.float64),
                      WcooPlan)


def test_empty_rows_and_defaults():
    # matrix with empty rows; default y=None path
    A = uniform_random(50, 50, 2, seed=11)
    x, _ = _operands_vec(A)
    plan = make_plan(A, dtype=jnp.float64)
    got = spmv(plan, jnp.asarray(x.values), 2.0)
    want = spmv_cpu(A, x, 2.0, 0.0, DenseVector.constant(A.height, 0.0))
    assert_equal(np.asarray(got), want)


def test_elementwise_parity():
    x = jnp.arange(8, dtype=jnp.float64)
    y = jnp.ones(8, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(axpby(x, y, 2.0, 3.0)),
                               2.0 * np.arange(8) + 3.0)
    np.testing.assert_allclose(np.asarray(plus_scalar(y, 5.0)), 6.0)


def test_bfloat16_plans_run():
    """bf16 value storage: supported end-to-end; checked
    at a bf16-appropriate tolerance rather than the f32/f64 ERROR_BAR."""
    import jax.numpy as jnp

    from sblas.io.generate import fem_banded_like
    from sblas.ops import make_plan, spmm, spmv

    A = fem_banded_like(n=400, half_band=3, dtype=np.float64)
    B = DenseMatrix.random(A.width, 8)
    C = DenseMatrix.constant(A.height, 8, 1.0)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    for force in ("bsr", "ell", "coo", "dia"):
        plan = make_plan(A, dtype=jnp.bfloat16, force=force)
        got = np.asarray(spmm(plan, jnp.asarray(B.values, jnp.bfloat16),
                              1.0, 1.0, jnp.asarray(C.values, jnp.bfloat16))
                         ).astype(np.float64)
        want = spmm_cpu(A, B, 1.0, 1.0, C)
        np.testing.assert_allclose(got, want, rtol=0.15, atol=0.15)
        gotv = np.asarray(spmv(plan, jnp.asarray(x.values, jnp.bfloat16),
                               1.0, 1.0, jnp.asarray(y.values, jnp.bfloat16))
                          ).astype(np.float64)
        wantv = spmv_cpu(A, x, 1.0, 1.0, y)
        np.testing.assert_allclose(gotv, wantv, rtol=0.15, atol=0.15)
