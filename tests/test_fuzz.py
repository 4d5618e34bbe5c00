"""Seeded randomized sweep: every plan kind on random shapes/structures/
scalars vs the CPU oracle.  Catches interactions the targeted tests
don't (odd shapes x layouts x alpha/beta signs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.containers import CsrMatrix, DenseMatrix, DenseVector
from sblas.ops import make_plan, spmm, spmv
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.utils.verify import assert_equal

KINDS = ["dia", "bsr", "ell", "wcoo", "coo", "routed"]


def _random_csr(rng):
    m = int(rng.integers(1, 400))
    n = int(rng.integers(1, 400))
    density = float(rng.uniform(0.001, 0.08))
    nnz = max(int(m * n * density), 1)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    dense = np.zeros((m, n))
    dense[rows, cols] = vals
    return CsrMatrix.from_dense(dense)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_all_kinds(seed):
    rng = np.random.default_rng(seed)
    A = _random_csr(rng)
    alpha = float(rng.uniform(-3, 3))
    beta = float(rng.uniform(-3, 3))
    k = int(rng.integers(1, 20))
    x = DenseVector.random(A.width)
    y = DenseVector.random(A.height)
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.random(A.height, k)
    want_v = spmv_cpu(A, x, alpha, beta, y)
    want_m = spmm_cpu(A, B, alpha, beta, C)
    for kind in KINDS:
        plan = make_plan(A, dtype=jnp.float64, force=kind)
        got = spmv(plan, jnp.asarray(x.values), alpha, beta,
                   jnp.asarray(y.values))
        assert_equal(np.asarray(got), want_v)
        if kind == "routed":
            continue  # SpMV-only plan
        gotm = spmm(plan, jnp.asarray(B.values), alpha, beta,
                    jnp.asarray(C.values))
        assert_equal(np.asarray(gotm), want_m)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_um_streaming(seed):
    """Host-resident band streaming on random structures x random budgets
    x both tuning modes, every kind auto-selected, vs the oracle."""
    from sblas.memory import host_resident_plan, spmm_um, spmv_um
    rng = np.random.default_rng(100 + seed)
    A = _random_csr(rng)
    budget = int(rng.integers(8, 200)) << 10
    tuning = bool(seed % 2)
    alpha = float(rng.uniform(-2, 2))
    beta = float(rng.uniform(-2, 2))
    hp = host_resident_plan(A, dtype=jnp.float64, hbm_budget_bytes=budget)
    x = DenseVector.random(A.width)
    y = DenseVector.random(A.height)
    got = spmv_um(hp, jnp.asarray(x.values), alpha, beta,
                  jnp.asarray(y.values), tuning=tuning)
    assert_equal(np.asarray(got), spmv_cpu(A, x, alpha, beta, y))
    k = int(rng.integers(1, 12))
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.random(A.height, k)
    gotm = spmm_um(hp, jnp.asarray(B.values), alpha, beta,
                   jnp.asarray(C.values), tuning=tuning)
    assert_equal(np.asarray(gotm), spmm_cpu(A, B, alpha, beta, C))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_um_hostdense(seed):
    """Random 2-D grid SpMM with B and C pinned host."""
    from sblas.memory import (HostDense, host_resident_grid,
                                  spmm_um_hostdense)
    rng = np.random.default_rng(200 + seed)
    A = _random_csr(rng)
    k = int(rng.integers(1, 10))
    budget = int(rng.integers(24, 200)) << 10
    alpha = float(rng.uniform(-2, 2))
    beta = float(rng.uniform(-2, 2))
    grid = host_resident_grid(A, dtype=jnp.float64,
                              hbm_budget_bytes=budget, k=k)
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.random(A.height, k)
    got = spmm_um_hostdense(grid, HostDense.from_array(B.values), alpha,
                            beta, HostDense.from_array(C.values),
                            tuning=bool(seed % 2))
    assert_equal(got.to_numpy(), spmm_cpu(A, B, alpha, beta, C))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_distributed_kinds(seed):
    """Random structures through partition_row_plans with every applicable
    kind, distributed SpMV/SpMM vs the oracle on the 8-device mesh."""
    from sblas.parallel import (make_mesh, partition_row_plans,
                                    spmm_mode2_planned, spmv_dist_planned,
                                    sync_to_host)
    rng = np.random.default_rng(300 + seed)
    A = _random_csr(rng)
    mesh = make_mesh(4)
    alpha = float(rng.uniform(-2, 2))
    beta = float(rng.uniform(-2, 2))
    x = DenseVector.random(A.width)
    y = DenseVector.random(A.height)
    want_v = spmv_cpu(A, x, alpha, beta, y)
    for kind in ("ell", "coo", "wcoo", "routed", None):
        shards = partition_row_plans(A, 4, dtype=jnp.float64, kind=kind)
        got = sync_to_host(spmv_dist_planned(
            shards, jnp.asarray(x.values), alpha, beta,
            jnp.asarray(y.values), mesh))
        assert_equal(got, want_v)
    k = int(rng.integers(1, 10))
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.random(A.height, k)
    want_m = spmm_cpu(A, B, alpha, beta, C)
    for kind in ("ell", "coo", "wcoo"):
        shards = partition_row_plans(A, 4, dtype=jnp.float64, kind=kind)
        got = sync_to_host(spmm_mode2_planned(
            shards, jnp.asarray(B.values), alpha, beta,
            jnp.asarray(C.values), mesh))
        assert_equal(got, want_m)
