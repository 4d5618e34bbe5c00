"""DIA (diagonal) plan: construction, SpMV/SpMM vs the CPU oracle,
planning heuristics."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.config import SBlasConfig
from sblas.containers import CsrMatrix, DenseMatrix, DenseVector
from sblas.io.generate import fem_banded_like, webbase_like
from sblas.ops import make_plan, spmm, spmv
from sblas.ops.dia import DiaPlan, dia_stats, spmm_dia, spmv_dia
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.utils.verify import assert_equal


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=500, half_band=7, dtype=np.float64)


def test_stats_banded(banded):
    st = dia_stats(banded)
    assert st["n_diags"] == 15
    assert st["blowup"] == pytest.approx(15 * 500 / banded.nnz, rel=1e-12)


def test_plan_roundtrip(banded):
    plan = DiaPlan.from_csr(banded, dtype=jnp.float64)
    dense = np.zeros(banded.shape)
    vals = np.asarray(plan.vals)
    for j, off in enumerate(plan.offsets):
        for i in range(banded.shape[0]):
            c = i + off
            if 0 <= c < banded.shape[1] and vals[i, j]:
                dense[i, c] = vals[i, j]
    assert np.allclose(dense, banded.to_dense())


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (3.0, 4.0), (2.0, 0.0)])
def test_spmv_matches_oracle(banded, alpha, beta):
    plan = DiaPlan.from_csr(banded, dtype=jnp.float64)
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = spmv_dia(plan, jnp.asarray(x.values), alpha, beta,
                   jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(banded, x, alpha, beta, y))


def test_spmm_matches_oracle(banded):
    plan = DiaPlan.from_csr(banded, dtype=jnp.float64)
    B = DenseMatrix.random(banded.width, 9)
    C = DenseMatrix.constant(banded.height, 9, 1.0)
    got = spmm_dia(plan, jnp.asarray(B.values), 3.0, 4.0,
                   jnp.asarray(C.values))
    assert_equal(np.asarray(got), spmm_cpu(banded, B, 3.0, 4.0, C))


def test_rectangular_tall_and_wide():
    rng = np.random.RandomState(3)
    for (m, n) in [(40, 25), (25, 40)]:
        dense = np.zeros((m, n))
        for off in (-3, 0, 2, 7):
            for i in range(m):
                c = i + off
                if 0 <= c < n:
                    dense[i, c] = rng.rand() + 0.1
        A = CsrMatrix.from_dense(dense)
        plan = DiaPlan.from_csr(A, dtype=jnp.float64)
        x = DenseVector.random(n)
        y = DenseVector.constant(m, 1.0)
        got = spmv_dia(plan, jnp.asarray(x.values), 2.0, 3.0,
                       jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))


def test_make_plan_dia_policy(banded):
    from sblas.ops.bsr import BsrPlan

    # SpMV planning: DIA when banded — unless BELL's blowup is low
    # enough that its HBM-bound matvec beats DIA's per-diagonal passes
    # (r5 chip matrix: bsr 0.067 vs dia 0.109 ms at blowup 5.3;
    # dia wins at blowup 24).  banded500 has blowup 26 -> DIA.
    assert isinstance(make_plan(banded, op="spmv"), DiaPlan)
    wide = fem_banded_like(n=700, half_band=40, dtype=np.float64)
    assert isinstance(make_plan(wide, op="spmv"), BsrPlan)  # blowup 5.4
    # SpMM / mixed use: small-padding BELL is chosen on the dense band
    assert isinstance(make_plan(banded), BsrPlan)
    assert isinstance(make_plan(banded, op="spmm"), BsrPlan)
    assert isinstance(make_plan(wide, op="spmm"), BsrPlan)
    # (lean DIA overtakes BELL again once padded bytes grow HBM-bound —
    # >256 MB, unreachable at unit-test scale; tests/test_plan_choices.py
    # pins the full-shell choice at experiment scale)


def test_make_plan_rejects_unbanded():
    W = webbase_like(n=4000, avg_deg=3.0)
    assert not DiaPlan.is_profitable(W)
    assert not isinstance(make_plan(W, op="spmv"), DiaPlan)


def test_dispatch_via_generic_entry_points(banded):
    plan = make_plan(banded, op="spmv", dtype=jnp.float64)
    assert isinstance(plan, DiaPlan)
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = spmv(plan, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(banded, x, 3.0, 4.0, y))
    B = DenseMatrix.random(banded.width, 5)
    C = DenseMatrix.constant(banded.height, 5, 1.0)
    gotm = spmm(plan, jnp.asarray(B.values), 1.0, 1.0, jnp.asarray(C.values))
    assert_equal(np.asarray(gotm), spmm_cpu(banded, B, 1.0, 1.0, C))


def test_guard_limits():
    banded = fem_banded_like(n=300, half_band=5, dtype=np.float64)
    tight = SBlasConfig(dia_max_diags=5)
    assert not DiaPlan.is_profitable(banded, tight)
    loose = SBlasConfig(dia_blowup_limit=0.5)
    assert not DiaPlan.is_profitable(banded, loose)
