"""Single-device CSR SpMV kernels:  y' = beta*y + alpha*A@x.

XLA replacements for the reference's cuSPARSE delegation
(`cusparseSpMV`, spmv.h:104-106).  Two formulations, selected by plan:

* COO gather + sorted `segment_sum` (works for any structure; on the GPU
  the scatter-add runs on atomics, so its summation order varies from run
  to run — results agree with the oracle to rounding, not bit for bit);
* ELL gather + row reduction (no scatter at all; fastest when rows are
  balanced).

The alpha/beta epilogue is fused into the same jitted computation — the
reference needs a separate axpby kernel launch for it (kernel.h:27-38 via
plusDenseVectorGPU, matrix.h:714-726); under XLA it fuses for free.

The other layouts live in `bsr.py`, `dia.py`, `wcoo.py`, `rspmv.py`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .plans import CooPlan, EllPlan


def segment_spmv(rows, cols, vals, x, m):
    """Traceable core: sorted COO triplets x vector -> (m,) partial result.
    Shared by the single-chip kernel and the distributed modes."""
    contrib = vals * jnp.take(x, cols, axis=0)
    return jax.ops.segment_sum(contrib, rows, num_segments=m,
                               indices_are_sorted=True)


@jax.jit
def spmv_coo(plan: CooPlan, x: jax.Array, alpha, beta,
             y: jax.Array) -> jax.Array:
    ax = segment_spmv(plan.rows, plan.cols, plan.vals, x, plan.shape[0])
    return beta * y + alpha * ax


@jax.jit
def spmv_ell(plan: EllPlan, x: jax.Array, alpha, beta,
             y: jax.Array) -> jax.Array:
    m = plan.shape[0]
    gathered = jnp.take(x, plan.cols, axis=0)        # (m_pad, L)
    ax = (plan.vals * gathered).sum(axis=1)[:m]
    return beta * y + alpha * ax


def spmv(plan, x, alpha=1.0, beta=1.0, y=None):
    """Dispatch on plan type.  `y=None` means beta term is dropped."""
    if y is None:
        y = jnp.zeros(plan.shape[0], dtype=plan.vals.dtype)
        beta = 0.0
    if isinstance(plan, EllPlan):
        return spmv_ell(plan, x, alpha, beta, y)
    if isinstance(plan, CooPlan):
        return spmv_coo(plan, x, alpha, beta, y)
    raise TypeError(f"unsupported plan type {type(plan).__name__}")
