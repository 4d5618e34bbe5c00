"""Block-sparse (BELL) plan and batched-matmul kernel tests vs the CPU oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import CsrMatrix, DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops import BsrPlan, bell_stats, make_plan, spmm, spmv
from sblas.ops.bsr import spmm_bsr, spmv_bsr
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu


MATRICES = {
    "banded": lambda: fem_banded_like(n=300, half_band=9),
    "uniform_dense_rows": lambda: uniform_random(200, 150, 24, seed=3),
    "tiny": lambda: uniform_random(5, 7, 2, seed=4),
    "skew": lambda: adversarial_skew(m=96, n=96, heavy_rows=1,
                                     heavy_nnz=64, light_nnz=1),
}


@pytest.fixture(params=sorted(MATRICES))
def A(request):
    return MATRICES[request.param]()


@pytest.mark.parametrize("block", [(8, 128), (128, 128), (16, 64)])
def test_bsr_roundtrip_structure(A, block):
    """The plan must reproduce the matrix exactly: reassemble dense from
    blocks and compare."""
    plan = BsrPlan.from_csr(A, dtype=jnp.float64, block=block)
    R, C = block
    n_brows, L = plan.bcol.shape
    dense = np.zeros((n_brows * R, ((A.shape[1] + C - 1) // C) * C))
    vals = np.asarray(plan.vals)
    bcol = np.asarray(plan.bcol)
    for br in range(n_brows):
        for s in range(L):
            c0 = bcol[br, s] * C
            dense[br * R:(br + 1) * R, c0:c0 + C] += vals[br, s]
    np.testing.assert_allclose(dense[:A.shape[0], :A.shape[1]], A.to_dense())


def test_bsr_spmm_matches_oracle(A):
    B = DenseMatrix.random(A.width, 40)
    C = DenseMatrix.constant(A.height, 40, 1.0)
    plan = BsrPlan.from_csr(A, dtype=jnp.float64, block=(8, 128))
    got = spmm_bsr(plan, jnp.asarray(B.values), 3.0, 4.0,
                   jnp.asarray(C.values))
    assert_equal(np.asarray(got), spmm_cpu(A, B, 3.0, 4.0, C))


def test_bsr_spmv_matches_oracle(A):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    plan = BsrPlan.from_csr(A, dtype=jnp.float64, block=(8, 128))
    got = spmv_bsr(plan, jnp.asarray(x.values), 3.0, 4.0,
                   jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 3.0, 4.0, y))


def test_dispatchers_accept_bsr():
    A = fem_banded_like(n=200, half_band=4)
    B = DenseMatrix.random(A.width, 8)
    x = DenseVector.random(A.width)
    plan = BsrPlan.from_csr(A, dtype=jnp.float64, block=(8, 128))
    got_m = spmm(plan, jnp.asarray(B.values), 2.0)
    want_m = spmm_cpu(A, B, 2.0, 0.0, DenseMatrix.constant(A.height, 8, 0.0))
    assert_equal(np.asarray(got_m), want_m)
    got_v = spmv(plan, jnp.asarray(x.values), 2.0)
    want_v = spmv_cpu(A, x, 2.0, 0.0, DenseVector.constant(A.height, 0.0))
    assert_equal(np.asarray(got_v), want_v)


def test_heuristic_prefers_bsr_for_banded_and_not_for_web():
    banded = fem_banded_like(n=1024, half_band=30)
    assert isinstance(make_plan(banded, dtype=jnp.float64), BsrPlan)
    web = webbase_like(n=3000, avg_deg=3.0)
    assert not isinstance(make_plan(web, dtype=jnp.float64), BsrPlan)


def test_bell_stats_banded():
    A = fem_banded_like(n=1024, half_band=30)
    st = bell_stats(A, (128, 128))
    assert st["n_brows"] == 8
    assert st["slots"] <= 3  # band +-30 reaches 3 block-cols at boundaries
    assert st["blowup"] < 8


def test_bsr_mode1_distributed(ash85):
    from sblas.parallel import make_mesh, spmm_mode1, sync_to_host
    mesh = make_mesh(4)
    B = DenseMatrix.random(ash85.width, 32)
    C = DenseMatrix.constant(ash85.height, 32, 1.0)
    plan = BsrPlan.from_csr(ash85, dtype=jnp.float64, block=(8, 128))
    got = spmm_mode1(plan, jnp.asarray(B.values), 3.0, 4.0,
                     jnp.asarray(C.values), mesh)
    assert_equal(sync_to_host(got), spmm_cpu(ash85, B, 3.0, 4.0, C))


@pytest.mark.parametrize("k", [256, 512])
def test_bsr_spmm_wide_k(k):
    """Wide B through the `spmm` dispatcher: the XLA BELL kernel serves
    every K (there is no separate wide-K kernel)."""
    A = fem_banded_like(n=600, half_band=12)
    plan = make_plan(A, dtype=jnp.float64, force="bsr")
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    got = spmm(plan, jnp.asarray(B.values), 2.0, 3.0, jnp.asarray(C.values))
    assert_equal(np.asarray(got), spmm_cpu(A, B, 2.0, 3.0, C))
