"""Multi-device UM ops: host-resident sparse A under the v1/v2 strategies
on the virtual CPU mesh (reference spmm_um.h:163-284, spmv_um.h:35-139 —
the UM ops ARE the multi-GPU drivers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   webbase_like)
from sblas.memory import (host_resident_plan, host_resident_shards,
                              spmm_um_dist, spmm_um_mode1, spmv_um_dist)
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.parallel import make_mesh, sync_to_host

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV)


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=2100, half_band=30)


@pytest.fixture(scope="module")
def weblike():
    return webbase_like(n=12000, avg_deg=3.0, seed=8, local_scale=150.0)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_dist_banded(mesh, banded, tuning):
    hs = host_resident_shards(banded, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=128 << 10)
    assert hs.n_bands > 1
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = sync_to_host(spmv_um_dist(
        hs, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values), mesh,
        tuning=tuning))
    assert_equal(got, spmv_cpu(banded, x, 3.0, 4.0, y))
    assert hs.tuned == tuning


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_dist_unstructured(mesh, weblike, tuning):
    """The reference's UM headline shape: webbase-class SpMV, A host-
    resident, multi-device, budget below the matrix size."""
    hs = host_resident_shards(weblike, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    assert hs.kind in ("wcoo", "coo")
    x = DenseVector.random(weblike.width)
    y = DenseVector.constant(weblike.height, 1.0)
    got = sync_to_host(spmv_um_dist(
        hs, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values), mesh,
        tuning=tuning))
    assert_equal(got, spmv_cpu(weblike, x, 2.0, 3.0, y))


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_dist_mode2(mesh, banded, tuning):
    hs = host_resident_shards(banded, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=256 << 10)
    B = DenseMatrix.random(banded.width, 8)
    C = DenseMatrix.constant(banded.height, 8, 1.0)
    got = sync_to_host(spmm_um_dist(
        hs, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values), mesh,
        tuning=tuning))
    assert_equal(got, spmm_cpu(banded, B, 3.0, 4.0, C))


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_mode1(mesh, banded, tuning):
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=256 << 10)
    B = DenseMatrix.random(banded.width, 16)
    C = DenseMatrix.constant(banded.height, 16, 1.0)
    got = sync_to_host(spmm_um_mode1(
        hp, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values), mesh,
        tuning=tuning))
    assert_equal(got, spmm_cpu(banded, B, 3.0, 4.0, C))


def test_spmm_um_dist_unstructured(mesh, weblike):
    hs = host_resident_shards(weblike, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    B = DenseMatrix.random(weblike.width, 4)
    C = DenseMatrix.constant(weblike.height, 4, 1.0)
    got = sync_to_host(spmm_um_dist(
        hs, jnp.asarray(B.values), 1.0, 2.0, jnp.asarray(C.values), mesh))
    assert_equal(got, spmm_cpu(weblike, B, 1.0, 2.0, C))


def test_um_dist_skewed_rows(mesh):
    """Straddling-adjacent behavior: nnz-balanced row-granular shards with
    pathological skew still verify."""
    A = adversarial_skew(m=1536, n=1536, heavy_rows=3, heavy_nnz=700)
    hs = host_resident_shards(A, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = sync_to_host(spmv_um_dist(
        hs, jnp.asarray(x.values), 2.0, 1.0, jnp.asarray(y.values), mesh))
    assert_equal(got, spmv_cpu(A, x, 2.0, 1.0, y))


def test_um_dist_tuning_lifecycle(mesh, banded):
    hs = host_resident_shards(banded, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=128 << 10)
    hs.apply_gpu_tuning(mesh)
    assert hs.tuned
    hs.remove_gpu_tuning()
    assert not hs.tuned
    hs.apply_gpu_tuning(mesh)
    hs.apply_cpu_tuning()
    assert not hs.tuned


def test_um_dist_bands_on_host(mesh, weblike):
    hs = host_resident_shards(weblike, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    for band in hs.bands:
        for leaf in jax.tree.leaves(band):
            assert leaf.sharding.memory_kind == "pinned_host"


@pytest.mark.parametrize("chunk", ["2", "3", "16"])
def test_um_dist_stream_chunking(mesh, banded, chunk, monkeypatch):
    """SBLAS_STREAM_CHUNK batches G bands per dispatch (and per psum) in
    the untuned streams; results must be identical for any G, including
    G larger than n_bands and a ragged tail."""
    monkeypatch.setenv("SBLAS_STREAM_CHUNK", chunk)
    hs = host_resident_shards(banded, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=128 << 10)
    assert hs.n_bands > 1
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = sync_to_host(spmv_um_dist(
        hs, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values), mesh))
    assert_equal(got, spmv_cpu(banded, x, 3.0, 4.0, y))

    B = DenseMatrix.random(banded.width, 8)
    C = DenseMatrix.constant(banded.height, 8, 1.0)
    got = sync_to_host(spmm_um_dist(
        hs, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values), mesh))
    assert_equal(got, spmm_cpu(banded, B, 3.0, 4.0, C))


@pytest.mark.parametrize("chunk", ["3"])
def test_um_mode1_stream_chunking(mesh, banded, chunk, monkeypatch):
    monkeypatch.setenv("SBLAS_STREAM_CHUNK", chunk)
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=128 << 10)
    assert hp.n_bands > 1
    B = DenseMatrix.random(banded.width, 16)
    C = DenseMatrix.constant(banded.height, 16, 1.0)
    got = sync_to_host(spmm_um_mode1(
        hp, jnp.asarray(B.values), 3.0, 4.0, jnp.asarray(C.values), mesh))
    assert_equal(got, spmm_cpu(banded, B, 3.0, 4.0, C))


def test_um_dist_tuned_plan_streamed_chunked(mesh, banded, monkeypatch):
    """A previously-tuned shard container driven through the UNTUNED loop
    (tuning=False) serves chunks from the prefetched stack — the
    _band_slices tuned branch under SBLAS_STREAM_CHUNK."""
    monkeypatch.setenv("SBLAS_STREAM_CHUNK", "3")
    hs = host_resident_shards(banded, N_DEV, dtype=jnp.float64,
                              hbm_budget_bytes=128 << 10)
    hs.apply_gpu_tuning(mesh)
    assert hs.tuned
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = sync_to_host(spmv_um_dist(
        hs, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values), mesh,
        tuning=False))
    assert_equal(got, spmv_cpu(banded, x, 3.0, 4.0, y))
