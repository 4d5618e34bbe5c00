"""HBM-exceeding dense operands: B and C pinned host, 2-D cell-grid SpMM
(reference DenseMatrix_um/DenseVector_um, matrix_um.h:735-814)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import DenseMatrix
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   webbase_like)
from sblas.memory import (HostDense, host_resident_grid,
                              spmm_um_hostdense)
from sblas.ops.cpu_reference import spmm_cpu


def _run(A, k, budget, tuning, alpha=3.0, beta=4.0):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    grid = host_resident_grid(A, dtype=jnp.float64,
                              hbm_budget_bytes=budget, k=k)
    Bh = HostDense.from_array(B.values)
    Ch = HostDense.from_array(C.values)
    got = spmm_um_hostdense(grid, Bh, alpha, beta, Ch, tuning=tuning)
    assert_equal(got.to_numpy(), spmm_cpu(A, B, alpha, beta, C))
    return grid


@pytest.mark.parametrize("tuning", [False, True])
def test_banded_budget_below_result(tuning):
    """Done-criterion: budget smaller than m x K bytes."""
    A = fem_banded_like(n=2000, half_band=20)
    k = 16
    result_bytes = A.height * k * 8
    grid = _run(A, k, result_bytes // 4, tuning)
    assert grid.n_bands > 1
    # banded structure leaves most of the grid empty
    assert len(grid.cells) < grid.n_bands * grid.n_chunks or \
        grid.n_chunks == 1


@pytest.mark.parametrize("tuning", [False, True])
def test_unstructured_budget_below_operands(tuning):
    A = webbase_like(n=6000, avg_deg=3.0, seed=4, local_scale=100.0)
    k = 8
    grid = _run(A, k, (A.height * k * 8) // 4, tuning)
    assert grid.kind in ("wcoo", "coo")


def test_skewed_rows():
    A = adversarial_skew(m=1024, n=1024, heavy_rows=2, heavy_nnz=512)
    _run(A, 4, 96 << 10, False, alpha=2.0, beta=0.5)


def test_column_chunking_engages():
    A = fem_banded_like(n=3000, half_band=10)
    grid = host_resident_grid(A, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10, k=8)
    assert grid.n_chunks > 1 and grid.n_bands > 1


def test_hostdense_lifecycle():
    h = HostDense.from_array(np.arange(12.0).reshape(3, 4))
    assert not h.tuned
    h.apply_gpu_tuning()
    assert h.tuned
    np.testing.assert_array_equal(np.asarray(h.chunk(1, 3)),
                                  np.arange(12.0).reshape(3, 4)[1:3])
    h.apply_cpu_tuning()
    assert not h.tuned
    assert h.values.sharding.memory_kind == "pinned_host"


def test_grid_cells_on_host():
    A = fem_banded_like(n=1500, half_band=8)
    grid = host_resident_grid(A, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10, k=8)
    for cell in grid.cells.values():
        for leaf in jax.tree.leaves(cell):
            assert leaf.sharding.memory_kind == "pinned_host"


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_hostdense(tuning):
    """x and y host-resident (DenseVector_um, matrix_um.h:918-1075)."""
    from sblas.containers import DenseVector
    from sblas.memory import spmv_um_hostdense
    from sblas.ops.cpu_reference import spmv_cpu
    A = fem_banded_like(n=1800, half_band=12)
    grid = host_resident_grid(A, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10, k=1)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_um_hostdense(grid, HostDense.from_array(x.values), 3.0, 4.0,
                            HostDense.from_array(y.values), tuning=tuning)
    assert got.to_numpy().shape == (A.height,)
    assert_equal(got.to_numpy(), spmv_cpu(A, x, 3.0, 4.0, y))
