"""Distributed modes over per-shard fast plans, on the virtual CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.parallel import (make_mesh, partition_halo_dia,
                                partition_row_plans, spmm_mode2_planned,
                                spmv_dist_planned, spmv_halo_planned,
                                sync_to_host)
from sblas.utils.verify import assert_equal

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV)


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=1100, half_band=6, dtype=np.float64)


@pytest.fixture(scope="module")
def ragged():
    return uniform_random(900, 700, nnz_per_row=5, seed=11, dtype=np.float64)


@pytest.mark.parametrize("kind", ["bsr", "ell", "dia"])
@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmm_mode2_planned(mesh, banded, kind, reduce):
    shards = partition_row_plans(banded, N_DEV, dtype=jnp.float64, kind=kind)
    assert shards.kind == kind
    B = DenseMatrix.random(banded.width, 9)
    C = DenseMatrix.constant(banded.height, 9, 1.0)
    got = sync_to_host(spmm_mode2_planned(
        shards, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values),
        mesh, reduce=reduce))
    assert_equal(np.asarray(got), spmm_cpu(banded, B, 3.0, 4.0, C))


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmv_dist_planned(mesh, ragged, reduce):
    shards = partition_row_plans(ragged, N_DEV, dtype=jnp.float64)
    x = DenseVector.random(ragged.width)
    y = DenseVector.constant(ragged.height, 1.0)
    got = sync_to_host(spmv_dist_planned(
        shards, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values),
        mesh, reduce=reduce))
    assert_equal(np.asarray(got), spmv_cpu(ragged, x, 3.0, 4.0, y))


def test_spmv_dist_planned_skewed(mesh):
    A = adversarial_skew(m=1024, n=1024, heavy_rows=2, heavy_nnz=512,
                         dtype=np.float64)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind="ell")
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = sync_to_host(spmv_dist_planned(
        shards, jnp.asarray(x.values), 2.0, 1.0, jnp.asarray(y.values),
        mesh))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 1.0, y))


def test_spmv_halo_planned(mesh, banded):
    shards = partition_halo_dia(banded, N_DEV, dtype=jnp.float64)
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = sync_to_host(spmv_halo_planned(
        shards, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values),
        mesh))
    assert_equal(np.asarray(got), spmv_cpu(banded, x, 3.0, 4.0, y))


def test_default_kind_selection(ragged):
    wide_band = fem_banded_like(n=700, half_band=40, dtype=np.float64)
    assert partition_row_plans(wide_band, 4).kind == "bsr"
    assert partition_row_plans(ragged, 4).kind == "ell"


def test_default_kind_skew_no_ell_blowup(mesh):
    """kind=None on a power-law matrix must NOT pick ELL (a
    band_rows x max_row_nnz allocation) — it falls back to COO segments,
    and the result still verifies."""
    A = adversarial_skew(m=4096, n=4096, heavy_rows=4, heavy_nnz=2048,
                         dtype=np.float64)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64)
    assert shards.kind in ("wcoo", "coo")
    # the stacked plan must stay near the nnz footprint, not m*max_row_nnz
    total_slots = shards.plan.vals.size
    assert total_slots < 8 * A.nnz + N_DEV * 128 * 128
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = sync_to_host(spmv_dist_planned(
        shards, jnp.asarray(x.values), 2.0, 1.0, jnp.asarray(y.values),
        mesh))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 1.0, y))


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmv_dist_planned_routed(mesh, reduce):
    """Distributed SpMV rides per-shard RoutedPlans."""
    A = uniform_random(1500, 1024, nnz_per_row=4, seed=3, dtype=np.float64)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind="routed")
    assert shards.kind == "routed"
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = sync_to_host(spmv_dist_planned(
        shards, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values),
        mesh, reduce=reduce))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 3.0, 4.0, y))


def test_routed_heuristic_needs_spmv_op():
    """kind=None never picks routed (like make_plan's ladder); the
    COO-family fallback is chosen instead."""
    A = adversarial_skew(m=1500, n=1024, heavy_rows=2, heavy_nnz=512,
                         seed=3, dtype=np.float64)
    assert partition_row_plans(A, 4, kind=None).kind in ("wcoo", "coo")


def test_routed_shards_reject_spmm(mesh):
    from sblas.utils.errors import PartitionError
    A = uniform_random(1500, 1024, nnz_per_row=4, seed=3, dtype=np.float64)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind="routed")
    B = DenseMatrix.random(A.width, 5)
    C = DenseMatrix.constant(A.height, 5, 1.0)
    with pytest.raises(PartitionError):
        spmm_mode2_planned(shards, jnp.asarray(B.values), 1.0, 1.0,
                           jnp.asarray(C.values), mesh)


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmm_mode2_planned_wcoo(mesh, reduce):
    """Distributed unstructured SpMM rides per-shard windowed-COO instead
    of tier-0 segments."""
    A = webbase_like(n=9000, avg_deg=3.0, seed=17, local_scale=120.0)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind="wcoo")
    assert shards.kind == "wcoo"
    B = DenseMatrix.random(A.width, 6)
    C = DenseMatrix.constant(A.height, 6, 1.0)
    got = sync_to_host(spmm_mode2_planned(
        shards, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values),
        mesh, reduce=reduce))
    assert_equal(np.asarray(got), spmm_cpu(A, B, 3.0, 4.0, C))


def test_spmv_dist_planned_wcoo(mesh):
    A = webbase_like(n=9000, avg_deg=3.0, seed=17, local_scale=120.0)
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind="wcoo")
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = sync_to_host(spmv_dist_planned(
        shards, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values),
        mesh))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (3.0, 4.0)])
def test_spmm_halo_planned(mesh, banded, alpha, beta):
    """Halo-exchange SpMM: neighbor B row blocks over the ring."""
    from sblas.parallel import spmm_halo_planned
    shards = partition_halo_dia(banded, N_DEV, dtype=jnp.float64)
    B = DenseMatrix.random(banded.width, 7)
    C = DenseMatrix.constant(banded.height, 7, 1.0)
    got = sync_to_host(spmm_halo_planned(
        shards, jnp.asarray(B.values), alpha, beta, jnp.asarray(C.values),
        mesh))
    assert_equal(np.asarray(got), spmm_cpu(banded, B, alpha, beta, C))
