"""Single-device CSR SpMM kernels:  C' = beta*C + alpha*A@B.

XLA replacements for the reference's `cusparseSpMM` calls
(spmm.h:146-149).  B and C are logical (K-minor) jax.Arrays; the reference's
row/col-major distinction (spmm.h:91-98 rejects row-major B) is a non-issue
under XLA, which owns physical layout.

Formulations:
* COO: gather B rows per nnz + sorted `segment_sum` over rows.  The (nnz, K)
  intermediate is chunked over B columns when large to bound HBM pressure.
* ELL: column-chunked gather + accumulate — scatter-free.

alpha/beta epilogue fused (vs the reference's separate axpby kernel launch,
kernel.h:27-38 / spmm.h:283).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .plans import CooPlan, EllPlan

# Cap on the materialized gather intermediate, in elements (~1 GB of
# f32).  Kept high on purpose: every K-chunk repeats the row gather's
# index work — chunking is a memory safety valve, not a perf knob.
_MAX_GATHER_ELEMS = 256 * 1024 * 1024


def _match_vma(z, *exemplars):
    """Promote `z`'s varying-manual-axes type to the union of the
    exemplars'.  Needed so a lax.scan carry initialized with jnp.zeros
    typechecks inside shard_map, where the scanned operands are
    device-varying but fresh zeros are replicated."""
    vma = set()
    for e in exemplars:
        vma |= set(getattr(jax.typeof(e), "vma", ()) or ())
    vma -= set(getattr(jax.typeof(z), "vma", ()) or ())
    if vma:
        z = jax.lax.pcast(z, tuple(sorted(vma)), to="varying")
    return z


def segment_spmm(rows, cols, vals, B, m, n_chunks: int = 1):
    """Traceable core: (sorted COO triplets) x B -> (m, k) via gather +
    sorted segment_sum.  Shared by the single-chip kernel and the
    distributed modes (which run it per shard inside shard_map).

    `n_chunks` > 1 bounds the (nnz, k) gather transient by chunking over
    B COLUMNS, which keeps every gather flat (not inside a loop)."""
    k = B.shape[1]
    if n_chunks <= 1 or k <= 1:
        contrib = vals[:, None] * jnp.take(B, cols, axis=0)
        return jax.ops.segment_sum(contrib, rows, num_segments=m,
                                   indices_are_sorted=True)
    kc = max(-(-k // n_chunks), 1)
    outs = []
    for k0 in range(0, k, kc):
        contrib = vals[:, None] * jnp.take(B[:, k0:k0 + kc], cols, axis=0)
        outs.append(jax.ops.segment_sum(contrib, rows, num_segments=m,
                                        indices_are_sorted=True))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)


@partial(jax.jit, static_argnames=("n_chunks",))
def spmm_coo(plan: CooPlan, B: jax.Array, alpha, beta, C: jax.Array,
             n_chunks: int = 1) -> jax.Array:
    ab = segment_spmm(plan.rows, plan.cols, plan.vals, B, plan.shape[0],
                      n_chunks=n_chunks)
    return beta * C + alpha * ab


@partial(jax.jit, static_argnames=("k_chunk",))
def spmm_ell(plan: EllPlan, B: jax.Array, alpha, beta, C: jax.Array,
             k_chunk: int = None) -> jax.Array:
    """ELL SpMM via one FLAT B-row gather per K-chunk; the transient is
    bounded by chunking over B columns."""
    m = plan.shape[0]
    m_pad, L = plan.cols.shape
    k = B.shape[1]
    kc = k_chunk or max(min(k, _MAX_GATHER_ELEMS // max(m_pad * L, 1)), 1)
    outs = []
    for k0 in range(0, k, kc):
        k1 = min(k0 + kc, k)
        gathered = jnp.take(B[:, k0:k1], plan.cols.reshape(-1), axis=0)
        gathered = gathered.reshape(m_pad, L, k1 - k0)
        outs.append((plan.vals[:, :, None] * gathered).sum(axis=1))
    ab = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    return beta * C + alpha * ab[:m]


def _auto_chunks(plan: CooPlan, k: int) -> int:
    total = plan.vals.shape[0] * k
    return max(1, (total + _MAX_GATHER_ELEMS - 1) // _MAX_GATHER_ELEMS)


def spmm(plan, B, alpha=1.0, beta=1.0, C=None):
    """Dispatch on plan type.  `C=None` drops the beta term."""
    if C is None:
        C = jnp.zeros((plan.shape[0], B.shape[1]), dtype=plan.vals.dtype)
        beta = 0.0
    if isinstance(plan, EllPlan):
        return spmm_ell(plan, B, alpha, beta, C)
    if isinstance(plan, CooPlan):
        return spmm_coo(plan, B, alpha, beta, C,
                        n_chunks=_auto_chunks(plan, B.shape[1]))
    raise TypeError(f"unsupported plan type {type(plan).__name__}")
