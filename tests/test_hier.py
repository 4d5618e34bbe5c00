"""Hierarchical (slice, chip) two-tier modes (parallel/hier.py) vs the
CPU oracle on the virtual 8-device mesh arranged 2x4 and 4x2."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random)
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.parallel import (make_mesh2, partition_row_plans,
                                spmm_mode2_hier, spmv_dist_hier,
                                sync_to_host)
from sblas.utils.verify import assert_equal


@pytest.mark.parametrize("s,c", [(2, 4), (4, 2)])
def test_hier_spmv(s, c):
    A = fem_banded_like(n=1024, half_band=4, dtype=np.float64)
    shards = partition_row_plans(A, s * c, dtype=jnp.float64)
    mesh = make_mesh2(s, c)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_dist_hier(shards, jnp.asarray(x.values), 3.0, 4.0,
                         jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 3.0, 4.0, y))


@pytest.mark.parametrize("s,c", [(2, 4), (4, 2)])
def test_hier_spmm(s, c):
    A = fem_banded_like(n=512, half_band=3, dtype=np.float64)
    shards = partition_row_plans(A, s * c, dtype=jnp.float64)
    mesh = make_mesh2(s, c)
    B = DenseMatrix.random(A.width, 16)
    C = DenseMatrix.constant(A.height, 16, 1.0)
    got = spmm_mode2_hier(shards, jnp.asarray(B.values), 3.0, 4.0,
                          jnp.asarray(C.values), mesh)
    assert_equal(sync_to_host(got), spmm_cpu(A, B, 3.0, 4.0, C))


def test_hier_unstructured_kinds():
    A = adversarial_skew(m=1024, n=1024, dtype=np.float64)
    shards = partition_row_plans(A, 8, dtype=jnp.float64, kind="coo")
    mesh = make_mesh2(2, 4)
    x = DenseVector.random(A.width)
    y = DenseVector.random(A.height)
    got = spmv_dist_hier(shards, jnp.asarray(x.values), 2.0, -1.0,
                         jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 2.0, -1.0, y))


def test_hier_routed_kind():
    A = uniform_random(1024, 1024, nnz_per_row=3, seed=8,
                       dtype=np.float64)
    shards = partition_row_plans(A, 8, dtype=jnp.float64, kind="routed")
    mesh = make_mesh2(2, 4)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_dist_hier(shards, jnp.asarray(x.values), 3.0, 4.0,
                         jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 3.0, 4.0, y))


def test_hier_shard_count_mismatch():
    from sblas.utils.errors import PartitionError
    A = fem_banded_like(n=256, half_band=2, dtype=np.float64)
    shards = partition_row_plans(A, 4, dtype=jnp.float64)
    mesh = make_mesh2(2, 4)
    with pytest.raises(PartitionError):
        spmv_dist_hier(shards, jnp.zeros(A.width), 1.0, 0.0,
                       jnp.zeros(A.height), mesh)

