"""Distributed-mode tests on the 8-device virtual CPU mesh: both reference
strategies (mode 1 / mode 2), the psum_scatter upgrade, the halo SpMV, and
placement policies — all verified against the CPU oracle (SURVEY.md §4's
'distributed testing without a cluster' gap, closed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import (CsrMatrix, DenseMatrix, DenseVector,
                                  MajorOrder, SharePolicy)
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random)
from sblas.ops import make_plan
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.parallel import (make_mesh, pad_to_shards, place_dense,
                                replicate, spmm_mode1, spmm_mode2, spmv_dist,
                                spmv_halo, sync_to_host)
from sblas.partition import partition_nnz_balanced, partition_row_blocks
from sblas.utils.errors import PartitionError

ALPHA, BETA = 3.0, 4.0


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _mats(A, k=16):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    return B, C


MATRICES = {
    "uniform": lambda: uniform_random(100, 80, 5, seed=3),
    "skew": lambda: adversarial_skew(m=96, n=64, heavy_rows=1,
                                     heavy_nnz=300, light_nnz=1),
    "banded": lambda: fem_banded_like(n=120, half_band=4),
}


@pytest.fixture(params=sorted(MATRICES))
def A(request):
    return MATRICES[request.param]()


@pytest.mark.parametrize("kind", ["coo", "ell"])
def test_spmm_mode1(A, mesh, kind):
    """Strategy 1: B/C column-sharded, A replicated, no collective
    (spmm.h:83-161 semantics)."""
    B, C = _mats(A, k=20)  # 20 not divisible by 8 -> exercises K padding
    plan = make_plan(A, dtype=jnp.float64, force=kind)
    got = spmm_mode1(plan, jnp.asarray(B.values), ALPHA, BETA,
                     jnp.asarray(C.values), mesh)
    assert_equal(sync_to_host(got), spmm_cpu(A, B, ALPHA, BETA, C))


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmm_mode2(A, mesh, reduce):
    """Strategy 2: A nnz-segmented (straddling rows), one sum collective
    (spmm.h:163-284 semantics; psum_scatter is the improved mechanism)."""
    B, C = _mats(A, k=16)
    segs = partition_nnz_balanced(A, 8, dtype=jnp.float64)
    got = spmm_mode2(segs, jnp.asarray(B.values), ALPHA, BETA,
                     jnp.asarray(C.values), mesh, reduce=reduce)
    assert_equal(sync_to_host(got), spmm_cpu(A, B, ALPHA, BETA, C))


@pytest.mark.parametrize("reduce", ["psum", "psum_scatter"])
def test_spmv_dist(A, mesh, reduce):
    """SpMV v1: A nnz-segmented, x replicated (spmv.h:35-139 semantics)."""
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    segs = partition_nnz_balanced(A, 8, dtype=jnp.float64)
    got = spmv_dist(segs, jnp.asarray(x.values), ALPHA, BETA,
                    jnp.asarray(y.values), mesh, reduce=reduce)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, ALPHA, BETA, y))


def test_spmv_halo_banded(mesh):
    """Halo SpMV: x sharded, neighbor blocks exchanged over the ring."""
    A = fem_banded_like(n=256, half_band=7)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 2.0)
    blocks = partition_row_blocks(A, 8, dtype=jnp.float64)
    got = spmv_halo(blocks, jnp.asarray(x.values), ALPHA, BETA,
                    jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, ALPHA, BETA, y))


def test_spmv_halo_rejects_wide_footprint(mesh):
    """Scattered columns exceed one-block halo -> planner metadata must
    reject (caller falls back to spmv_dist)."""
    A = uniform_random(128, 128, 3, seed=7)  # uniform columns: global reach
    blocks = partition_row_blocks(A, 8, dtype=jnp.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 0.0)
    with pytest.raises(PartitionError):
        spmv_halo(blocks, jnp.asarray(x.values), 1.0, 0.0,
                  jnp.asarray(y.values), mesh)


def test_mode2_on_ash85(ash85, mesh):
    """The reference's spmmCsrTest2 shape: ash85, K=256, alpha=3, beta=4,
    n=4 devices (unit_test.cu:100-137)."""
    mesh4 = make_mesh(4)
    B, C = _mats(ash85, k=256)
    segs = partition_nnz_balanced(ash85, 4, dtype=jnp.float64)
    got = spmm_mode2(segs, jnp.asarray(B.values), 3.0, 4.0,
                     jnp.asarray(C.values), mesh4)
    assert_equal(sync_to_host(got), spmm_cpu(ash85, B, 3.0, 4.0, C))


def test_placement_policies(mesh):
    a = np.arange(64, dtype=np.float64).reshape(8, 8)
    rep = place_dense(a, mesh, SharePolicy.REPLICATE)
    assert rep.sharding.is_fully_replicated
    seg = place_dense(a, mesh, SharePolicy.SEGMENT, segment_dim=1)
    assert not seg.sharding.is_fully_replicated
    np.testing.assert_array_equal(sync_to_host(seg), a)
    with pytest.raises(PartitionError):
        place_dense(np.zeros((6, 6)), mesh, SharePolicy.SEGMENT)


def test_pad_to_shards():
    a = np.ones((10, 3))
    p = pad_to_shards(a, 8, dim=0)
    assert p.shape[0] % 8 == 0 and np.all(p[:10] == 1) and np.all(p[10:] == 0)


def test_segment_axis_follows_major_order(mesh):
    """Col-major dense segments along columns, row-major along rows
    (matrix.h:554-568 first_order/second_order semantics)."""
    d = DenseMatrix.random(8, 8, order=MajorOrder.COL_MAJOR)
    placed = place_dense(d.values, mesh, SharePolicy.SEGMENT,
                         segment_dim=d.segment_axis)
    spec = placed.sharding.spec
    assert spec[1] is not None or len(spec) > 1


def test_spmm_mode1_wcoo_plan():
    """Mode 1 with a wcoo plan runs under check_vma=True and matches the
    oracle."""
    import jax.numpy as jnp
    import numpy as np

    from sblas.containers import DenseMatrix
    from sblas.io.generate import webbase_like
    from sblas.ops.cpu_reference import spmm_cpu
    from sblas.ops.wcoo import WcooPlan
    from sblas.parallel import make_mesh, spmm_mode1, sync_to_host
    from sblas.utils.verify import assert_equal

    A = webbase_like(n=4096, avg_deg=3.0, seed=1, dtype=np.float64)
    plan = WcooPlan.from_csr(A, dtype=jnp.float64)
    B = DenseMatrix.random(A.shape[1], 8)
    C = DenseMatrix.constant(A.shape[0], 8, 1.0)
    out = sync_to_host(spmm_mode1(plan, jnp.asarray(B.values), 3.0, 4.0,
                                  jnp.asarray(C.values), make_mesh(4)))
    assert_equal(out, spmm_cpu(A, B, 3.0, 4.0, C))
