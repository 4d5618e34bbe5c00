"""shard_map varying-manual-axes typechecking coverage.

Every shard program runs with check_vma=True.  Two facts are pinned here
on the 8-device CPU mesh:

* the unstructured kinds' shard programs trace under check_vma=True
  (vma checking happens at shard_map trace time, so `jax.eval_shape`
  suffices);
* every plan kind also executes under check_vma=True through the planned
  mode-2 entry points and matches the CPU oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from sblas.containers import DenseMatrix, DenseVector
from sblas.io.generate import fem_banded_like, webbase_like
from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas.parallel.mesh import make_mesh
from sblas.parallel.planned import (_local_spmm, _local_spmv, _unstack,
                                    partition_row_plans, spmm_mode2_planned,
                                    spmv_dist_planned)

N_DEV = 8


@pytest.fixture
def mesh():
    return make_mesh(N_DEV)


@pytest.fixture
def A():
    return webbase_like(n=4096, avg_deg=3.0, seed=1, dtype=np.float64)


@pytest.mark.parametrize("kind,op", [("wcoo", "spmm"), ("wcoo", "spmv"),
                                     ("routed", "spmv")])
def test_compiled_path_traces_with_check_vma(mesh, A, kind, op):
    """The unstructured kinds' shard programs typecheck under
    check_vma=True."""
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind=kind)
    operand = (jnp.zeros((A.shape[1], 16), jnp.float64) if op == "spmm"
               else jnp.zeros(A.shape[1], jnp.float64))

    def fn(sh, v):
        plan = _unstack(sh.plan)
        return (_local_spmm(kind, plan, v) if op == "spmm"
                else _local_spmv(kind, plan, v))

    out_spec = P("shards", None) if op == "spmm" else P("shards")
    prog = jax.shard_map(fn, mesh=mesh, in_specs=(P("shards"), P()),
                         out_specs=out_spec, check_vma=True)
    out = jax.eval_shape(prog, shards, operand)
    rows = shards.band_rows * N_DEV
    assert out.shape == ((rows, 16) if op == "spmm" else (rows,))


@pytest.mark.parametrize("kind,op", [("dia", "spmv"), ("bsr", "spmm"),
                                     ("ell", "spmm"), ("coo", "spmv"),
                                     ("wcoo", "spmv"), ("routed", "spmv")])
def test_every_kind_runs_with_check_vma(mesh, kind, op):
    """Each plan kind executes inside a check_vma=True shard program and
    matches the oracle (a banded matrix for the dense-band kinds, a web
    proxy for the gather kinds)."""
    A = (fem_banded_like(n=2048, half_band=4, dtype=np.float64)
         if kind in ("dia", "bsr")
         else webbase_like(n=4096, avg_deg=3.0, seed=1, dtype=np.float64))
    shards = partition_row_plans(A, N_DEV, dtype=jnp.float64, kind=kind)
    if op == "spmv":
        x = DenseVector.random(A.width, dtype=np.float64)
        y = DenseVector.constant(A.height, 1.0, dtype=np.float64)
        out = spmv_dist_planned(shards, jnp.asarray(x.values), 2.0, 3.0,
                                jnp.asarray(y.values), mesh)
        want = spmv_cpu(A, x, 2.0, 3.0, y)
    else:
        B = DenseMatrix.random(A.width, 8, dtype=np.float64)
        C = DenseMatrix.constant(A.height, 8, 1.0, dtype=np.float64)
        out = spmm_mode2_planned(shards, jnp.asarray(B.values), 2.0, 3.0,
                                 jnp.asarray(C.values), mesh)
        want = spmm_cpu(A, B, 2.0, 3.0, C)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-9, atol=1e-9)
