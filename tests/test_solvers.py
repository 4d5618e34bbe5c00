"""Iterative solvers (sblas/solvers.py) vs dense/numpy references."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.containers import CooMatrix
from sblas.io.generate import fem_banded_like, webbase_like
from sblas.ops import make_plan
from sblas.solvers import SolveResult, cg, pagerank

N_DEV = 4


def _spd(n=600, half_band=4):
    """Banded pattern symmetrized + diagonally dominant shift."""
    A = fem_banded_like(n=n, half_band=half_band, dtype=np.float64)
    coo = A.to_coo()
    rows = np.concatenate([coo.row_idx, coo.col_idx])
    cols = np.concatenate([coo.col_idx, coo.row_idx])
    vals = np.concatenate([coo.values, coo.values])
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, np.abs(vals))
    d = np.arange(n)
    return CooMatrix(np.concatenate([rows, d]), np.concatenate([cols, d]),
                     np.concatenate([vals, 1.0 + rowsum]),
                     (n, n)).to_csr()


@pytest.fixture(scope="module")
def spd():
    A = _spd()
    rng = np.random.RandomState(7)
    x_true = rng.standard_normal(A.shape[0])
    dense = np.zeros(A.shape)
    coo = A.to_coo()
    dense[coo.row_idx, coo.col_idx] = coo.values
    b = dense @ x_true
    return A, x_true, b


def test_cg_single_chip(spd):
    A, x_true, b = spd
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    res = cg(plan, jnp.asarray(b), tol=1e-10, maxiter=3000)
    assert isinstance(res, SolveResult)
    assert res.converged and 0 < res.iterations < 3000
    assert res.residual <= 1e-10 * 1.01
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_maxiter_cap(spd):
    A, _, b = spd
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    res = cg(plan, jnp.asarray(b), tol=1e-14, maxiter=2)
    assert res.iterations == 2 and not res.converged


def test_cg_callable_and_jacobi_preconditioner(spd):
    A, x_true, b = spd
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    from sblas.ops import spmv

    def mv(v):
        return spmv(plan, v, 1.0, 0.0, jnp.zeros_like(v))

    coo = A.to_coo()
    diag = np.zeros(A.shape[0])
    sel = coo.row_idx == coo.col_idx
    diag[coo.row_idx[sel]] = coo.values[sel]
    inv_d = jnp.asarray(1.0 / diag)
    plain = cg(mv, jnp.asarray(b), tol=1e-10, maxiter=3000)
    pre = cg(mv, jnp.asarray(b), tol=1e-10, maxiter=3000,
             M=lambda v: inv_d * v)
    assert plain.converged and pre.converged
    assert pre.iterations <= plain.iterations  # Jacobi can't hurt here
    np.testing.assert_allclose(np.asarray(pre.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_array_M_and_jacobi_helper(spd):
    """M passed as an ARRAY (inverse diagonal, threaded through the jit
    as an argument per the no-closure rule) must match the callable
    form; jacobi_inv_diag must extract the same vector."""
    from sblas.solvers import jacobi_inv_diag
    A, x_true, b = spd
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    inv_d = jacobi_inv_diag(A, dtype=jnp.float64)
    coo = A.to_coo()
    sel = coo.row_idx == coo.col_idx
    want = np.ones(A.shape[0])
    want[coo.row_idx[sel]] = 1.0 / coo.values[sel]
    np.testing.assert_allclose(np.asarray(inv_d), want)
    res_arr = cg(plan, jnp.asarray(b), tol=1e-10, maxiter=3000, M=inv_d)
    res_fn = cg(plan, jnp.asarray(b), tol=1e-10, maxiter=3000,
                M=lambda v: inv_d * v)
    assert res_arr.converged
    assert res_arr.iterations == res_fn.iterations
    np.testing.assert_allclose(np.asarray(res_arr.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_distributed_shards(spd):
    from sblas.parallel import make_mesh, partition_row_plans
    A, x_true, b = spd
    mesh = make_mesh(N_DEV)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64)
    res = cg(shards, jnp.asarray(b), tol=1e-10, maxiter=3000, mesh=mesh)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_xfoot_shards(spd):
    from sblas.parallel import make_mesh, partition_xfoot
    A, x_true, b = spd
    mesh = make_mesh(N_DEV)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64)
    res = cg(shards, jnp.asarray(b), tol=1e-10, maxiter=3000, mesh=mesh)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_pagerank_matches_numpy_power_iteration():
    G = webbase_like(n=3000, avg_deg=3.0, seed=11, local_scale=60.0,
                     dtype=np.float64)
    n = G.shape[0]
    coo = G.to_coo()
    outdeg = np.maximum(G.row_nnz, 1).astype(np.float64)
    PT = CooMatrix(coo.col_idx, coo.row_idx,
                   1.0 / outdeg[coo.row_idx], (n, n)).to_csr()
    dangling = (G.row_nnz == 0).astype(np.float64)
    plan = make_plan(PT, dtype=jnp.float64, op="spmv")
    res = pagerank(plan, n, dangling=jnp.asarray(dangling), damping=0.85,
                   tol=1e-12, maxiter=500,
                   r0=jnp.full(n, 1.0 / n, jnp.float64))
    assert res.converged and res.iterations < 500
    r = np.asarray(res.x)
    assert abs(r.sum() - 1.0) < 1e-9

    # numpy reference power iteration
    dense = np.zeros((n, n))
    dense[coo.col_idx, coo.row_idx] = 1.0 / outdeg[coo.row_idx]
    rr = np.full(n, 1.0 / n)
    for _ in range(500):
        r_new = 0.85 * (dense @ rr + dangling @ rr / n) + 0.15 / n
        if np.abs(r_new - rr).sum() <= 1e-12:
            rr = r_new
            break
        rr = r_new
    np.testing.assert_allclose(r, rr, rtol=1e-8, atol=1e-12)


def _nonsym(n=800, seed=5):
    """Nonsymmetric directed-graph pattern + diagonal dominance."""
    G = webbase_like(n=n, avg_deg=4.0, seed=seed, local_scale=40.0,
                     dtype=np.float64)
    coo = G.to_coo()
    rowsum = np.zeros(n)
    np.add.at(rowsum, coo.row_idx, np.abs(coo.values))
    d = np.arange(n)
    return CooMatrix(np.concatenate([coo.row_idx, d]),
                     np.concatenate([coo.col_idx, d]),
                     np.concatenate([coo.values, 1.0 + rowsum]),
                     (n, n)).to_csr()


def test_bicgstab_nonsymmetric():
    from sblas.solvers import bicgstab
    A = _nonsym()
    n = A.shape[0]
    rng = np.random.RandomState(3)
    x_true = rng.standard_normal(n)
    dense = np.zeros((n, n))
    coo = A.to_coo()
    dense[coo.row_idx, coo.col_idx] = coo.values
    assert not np.allclose(dense, dense.T)  # genuinely nonsymmetric
    b = dense @ x_true
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    res = bicgstab(plan, jnp.asarray(b), tol=1e-10, maxiter=2000)
    assert res.converged and res.iterations < 2000
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_bicgstab_distributed_matches_cg_on_spd(spd):
    from sblas.parallel import make_mesh, partition_xfoot
    from sblas.solvers import bicgstab
    A, x_true, b = spd
    mesh = make_mesh(N_DEV)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64)
    res = bicgstab(shards, jnp.asarray(b), tol=1e-10, maxiter=3000,
                   mesh=mesh)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_accepts_raw_csr():
    """A raw CsrMatrix is planned internally (dtype follows b)."""
    A = _spd(n=400)
    rng = np.random.RandomState(1)
    x_true = rng.standard_normal(A.shape[0])
    dense = np.zeros(A.shape)
    coo = A.to_coo()
    dense[coo.row_idx, coo.col_idx] = coo.values
    res = cg(A, jnp.asarray(dense @ x_true), tol=1e-10, maxiter=2000)
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_repeat_solves_do_not_retrace(spd):
    """cg() in a loop over right-hand sides must reuse the jitted
    program (a fresh jax.jit per call retraced and recompiled every
    solve)."""
    A, x_true, b = spd
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    from sblas.ops import spmv
    traces = []

    def mv(v):
        traces.append(1)
        return spmv(plan, v, 1.0, 0.0, jnp.zeros_like(v))

    r1 = cg(mv, jnp.asarray(b), tol=1e-10, maxiter=3000)
    n1 = len(traces)
    assert n1 > 0 and r1.converged
    r2 = cg(mv, jnp.asarray(b * 2.0), tol=1e-10, maxiter=3000)
    assert len(traces) == n1, "second solve retraced the program"
    np.testing.assert_allclose(np.asarray(r2.x), 2.0 * x_true, rtol=1e-6,
                               atol=1e-8)
