"""UM-analog tests: host-resident band plans, streamed SpMM/SpMV, tuning
lifecycle — CPU-mesh versions of the reference's spmm_test_um/spmv_test_um
surface (spmm_test_um.cu:77-161)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas import assert_equal
from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import fem_banded_like, uniform_random
from sblas.memory import host_resident_plan, spmm_um, spmv_um
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=2000, half_band=40)


def test_band_partitioning(banded):
    # tiny budget forces many bands
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=256 << 10)
    assert hp.n_bands > 1
    assert hp.band_rows * hp.n_bands >= banded.height
    assert not hp.tuned


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_matches_oracle(banded, tuning):
    B = DenseMatrix.random(banded.width, 16)
    C = DenseMatrix.constant(banded.height, 16, 1.0)
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=256 << 10)
    got = spmm_um(hp, jnp.asarray(B.values), 3.0, 4.0,
                  jnp.asarray(C.values), tuning=tuning)
    assert_equal(np.asarray(got), spmm_cpu(banded, B, 3.0, 4.0, C))
    assert hp.tuned == tuning


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_matches_oracle(banded, tuning):
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=256 << 10)
    got = spmv_um(hp, jnp.asarray(x.values), 3.0, 4.0,
                  jnp.asarray(y.values), tuning=tuning)
    assert_equal(np.asarray(got), spmv_cpu(banded, x, 3.0, 4.0, y))


def test_tuning_lifecycle(banded):
    """applyGpuTuning / removeGpuTuning / applyCpuTuning parity
    (matrix_um.h:529-614)."""
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=512 << 10)
    hp.apply_gpu_tuning()
    assert hp.tuned
    hp.remove_gpu_tuning()
    assert not hp.tuned
    hp.apply_gpu_tuning()
    hp.apply_cpu_tuning()
    assert not hp.tuned


def test_ell_fallback_kind():
    A = uniform_random(500, 400, 3, seed=6)  # scattered -> not BSR-friendly
    hp = host_resident_plan(A, dtype=jnp.float64, hbm_budget_bytes=1 << 20)
    assert hp.kind == "ell"
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 0.5)
    got = spmv_um(hp, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))


def test_single_band_degenerate(banded):
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=1 << 30)
    assert hp.n_bands == 1
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = spmv_um(hp, jnp.asarray(x.values), 1.0, 1.0, jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(banded, x, 1.0, 1.0, y))


def test_bands_live_on_host(banded):
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=256 << 10)
    for band in hp.bands:
        for leaf in jax.tree.leaves(band):
            assert leaf.sharding.memory_kind == "pinned_host"


@pytest.fixture(scope="module")
def weblike():
    """Unstructured power-law matrix — the reference's own UM headline
    workload class (webbase-1M via spmv_test_um, profiling.sh:16)."""
    from sblas.io.generate import webbase_like
    return webbase_like(n=20000, avg_deg=3.0, seed=5,
                        local_scale=200.0)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_unstructured(weblike, tuning):
    """The UM analog must swallow webbase-class CSR with
    a budget smaller than the matrix, both tuning modes."""
    matrix_bytes = weblike.nnz * (8 + 8 + 8)
    hp = host_resident_plan(weblike, dtype=jnp.float64,
                            hbm_budget_bytes=matrix_bytes // 4)
    assert hp.kind == "wcoo"
    assert hp.n_bands > 1
    x = DenseVector.random(weblike.width)
    y = DenseVector.constant(weblike.height, 1.0)
    got = spmv_um(hp, jnp.asarray(x.values), 3.0, 4.0,
                  jnp.asarray(y.values), tuning=tuning)
    assert_equal(np.asarray(got), spmv_cpu(weblike, x, 3.0, 4.0, y))


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_unstructured(weblike, tuning):
    B = DenseMatrix.random(weblike.width, 8)
    C = DenseMatrix.constant(weblike.height, 8, 1.0)
    hp = host_resident_plan(weblike, dtype=jnp.float64,
                            hbm_budget_bytes=1 << 20)
    got = spmm_um(hp, jnp.asarray(B.values), 3.0, 4.0,
                  jnp.asarray(C.values), tuning=tuning)
    assert_equal(np.asarray(got), spmm_cpu(weblike, B, 3.0, 4.0, C))


def test_um_adversarial_skew_streams():
    """Power-law rows must not blow the band layout up (no ELL wall)."""
    from sblas.io.generate import adversarial_skew
    A = adversarial_skew(m=2048, n=2048, heavy_rows=3, heavy_nnz=1024)
    hp = host_resident_plan(A, dtype=jnp.float64, hbm_budget_bytes=256 << 10)
    assert hp.kind in ("wcoo", "coo")
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_um(hp, jnp.asarray(x.values), 2.0, 1.0, jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 1.0, y))


def test_um_forced_coo_kind(weblike):
    hp = host_resident_plan(weblike, dtype=jnp.float64,
                            hbm_budget_bytes=1 << 20, kind="coo")
    assert hp.kind == "coo"
    x = DenseVector.random(weblike.width)
    y = DenseVector.constant(weblike.height, 1.0)
    got = spmv_um(hp, jnp.asarray(x.values), 1.0, 2.0, jnp.asarray(y.values),
                  tuning=True)
    assert_equal(np.asarray(got), spmv_cpu(weblike, x, 1.0, 2.0, y))


@pytest.mark.parametrize("tuning", [False, True])
def test_many_bands_scan_fallback(tuning):
    """Above _UNROLL_MAX_BANDS the tuned program falls back to lax.scan
    (unrolled programs are linear in band count); results must match
    either way."""
    from sblas.memory.host import _UNROLL_MAX_BANDS
    A = fem_banded_like(n=3600, half_band=5)
    hp = host_resident_plan(A, dtype=jnp.float64,
                            hbm_budget_bytes=40 << 10)
    assert hp.n_bands > _UNROLL_MAX_BANDS
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_um(hp, jnp.asarray(x.values), 2.0, 3.0,
                  jnp.asarray(y.values), tuning=tuning)
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))


@pytest.mark.parametrize("chunk", ["2", "5"])
def test_um_stream_chunking_single_chip(banded, chunk, monkeypatch):
    """Untuned single-chip streaming with G bands per dispatch matches the
    oracle for ragged and even chunkings."""
    import jax.numpy as jnp
    from sblas.memory import host_resident_plan, spmm_um, spmv_um
    monkeypatch.setenv("SBLAS_STREAM_CHUNK", chunk)
    hp = host_resident_plan(banded, dtype=jnp.float64,
                            hbm_budget_bytes=128 << 10)
    assert hp.n_bands > 1
    x = DenseVector.random(banded.width)
    y = DenseVector.constant(banded.height, 1.0)
    got = np.asarray(spmv_um(hp, jnp.asarray(x.values), 3.0, 4.0,
                             jnp.asarray(y.values)))
    assert_equal(got, spmv_cpu(banded, x, 3.0, 4.0, y))
    B = DenseMatrix.random(banded.width, 8)
    C = DenseMatrix.constant(banded.height, 8, 1.0)
    got = np.asarray(spmm_um(hp, jnp.asarray(B.values), 3.0, 4.0,
                             jnp.asarray(C.values)))
    assert_equal(got, spmm_cpu(banded, B, 3.0, 4.0, C))
