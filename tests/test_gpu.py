"""Checks that only mean something on the GPU (marked `gpu`; they skip on
the CPU test mesh).  Run on the card with

    SBLAS_TEST_ON_DEVICE=1 python -m pytest tests/ -m gpu -p no:cacheprovider
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import fem_banded_like, webbase_like
from sblas.ops import make_plan, spmm, spmv
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu

pytestmark = pytest.mark.gpu


def test_cusparse_csr_lowering(gpu):
    """jax.experimental.sparse CSR products lower to cuSPARSE custom calls
    on the card and match the oracle."""
    from jax.experimental import sparse
    A = webbase_like(n=20_000, avg_deg=3.0, seed=3, dtype=np.float32)
    x = DenseVector.random(A.width, dtype=np.float32)
    M = sparse.CSR((jnp.asarray(A.values), jnp.asarray(A.col_idx, jnp.int32),
                    jnp.asarray(A.row_ptr, jnp.int32)), shape=A.shape)
    f = jax.jit(lambda m, v: m @ v)
    assert "cusparse" in f.lower(M, jnp.asarray(x.values)).as_text()
    want = spmv_cpu(A, x, 1.0, 0.0, DenseVector.constant(A.height, 0.0))
    np.testing.assert_allclose(np.asarray(f(M, jnp.asarray(x.values))),
                               want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["bsr", "dia"])
def test_f32_dots_are_not_tf32(gpu, kind):
    """Dense-block and diagonal kernels keep f32 accuracy (~1e-6
    relative); a TF32 matmul would land near 1e-3."""
    A = fem_banded_like(n=4096, half_band=40, dtype=np.float32)
    B = DenseMatrix.random(A.width, 64, dtype=np.float32)
    C = DenseMatrix.constant(A.height, 64, 0.0, dtype=np.float32)
    plan = make_plan(A, dtype=jnp.float32, force=kind)
    got = np.asarray(spmm(plan, jnp.asarray(B.values), 1.0, 0.0,
                          jnp.asarray(C.values)))
    want = spmm_cpu(A, B, 1.0, 0.0, C)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-5, err


def test_pinned_host_bands(gpu):
    """Host-streamed plans keep their bands in pinned host memory and
    still match the oracle."""
    from sblas.memory import host_resident_plan, spmv_um
    kinds = {m.kind for m in gpu.addressable_memories()}
    assert {"device", "pinned_host"} <= kinds
    A = webbase_like(n=50_000, avg_deg=3.0, seed=3, dtype=np.float32)
    hp = host_resident_plan(A, dtype=jnp.float32, hbm_budget_bytes=1 << 20)
    assert hp.n_bands > 1
    assert hp.bands[0].vals.sharding.memory_kind == "pinned_host"
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    got = spmv_um(hp, jnp.asarray(x.values), 2.0, 3.0,
                  jnp.asarray(y.values))
    np.testing.assert_allclose(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y),
                               rtol=1e-4, atol=1e-4)


def test_make_plan_spmv_runs(gpu):
    A = webbase_like(n=100_000, dtype=np.float32)
    x = DenseVector.random(A.width, dtype=np.float32)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
    plan = make_plan(A, dtype=jnp.float32, op="spmv")
    got = spmv(plan, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values))
    np.testing.assert_allclose(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y),
                               rtol=1e-4, atol=1e-4)
