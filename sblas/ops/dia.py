"""Diagonal (DIA) plan: shift-and-FMA SpMV for banded matrices.

The reference hands banded matrices (its SpMM benchmark s3dkq4m2 is FEM,
profiling.sh:6) to cuSPARSE's generic CSR machinery (spmv.h:104-106).  The
banded case has a gather-free formulation: store one dense value column
per occupied diagonal and compute

    y = sum_j  vals[:, j] * x[offset_j : offset_j + m]

Every term is a *static-offset* slice of x, so XLA fuses the whole sum into
one elementwise pass: traffic = the value columns (= nnz when the
diagonals are full) + one x re-read per diagonal, no gather or scatter
anywhere.

SpMM over DIA re-reads B once per diagonal; `make_plan` picks it for SpMM
when the BELL padding of the same band grows large (on the H100 it is the
fastest buildable kind for the shell proxy at K=64).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix


def dia_stats(A: CsrMatrix) -> dict:
    """Structural probe: occupied-diagonal count and storage blowup."""
    coo = A.to_coo()
    m = max(A.height, 1)
    offs = np.unique(coo.col_idx - coo.row_idx) if A.nnz else np.zeros(
        1, np.int64)
    return {
        "n_diags": len(offs),
        "offsets": offs,
        "blowup": len(offs) * m / max(A.nnz, 1),
    }


def dia_arrays(A: CsrMatrix, offsets=None, n_rows: int = None) -> tuple:
    """DIA value matrix as host numpy: (vals (n_rows, len(offsets)),
    offsets tuple).  `offsets` defaults to A's occupied diagonals; pass a
    superset to build shards sharing one static offset list."""
    coo = A.to_coo()
    if offsets is None:
        offsets = dia_stats(A)["offsets"]
    offsets = np.asarray(offsets, dtype=np.int64)
    n_rows = n_rows if n_rows is not None else max(A.height, 1)
    vals = np.zeros((n_rows, len(offsets)), dtype=A.values.dtype)
    if A.nnz:
        j = np.searchsorted(offsets, coo.col_idx - coo.row_idx)
        vals[coo.row_idx, j] = coo.values
    return vals, tuple(int(o) for o in offsets)


@partial(jax.tree_util.register_dataclass,
         data_fields=["vals"],
         meta_fields=["offsets", "shape", "nnz"])
@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Diagonal storage: vals[i, j] = A[i, i + offsets[j]] (0 if absent).

    `offsets` is a static (hashable) tuple so the per-diagonal slice loop
    unrolls at trace time with constant offsets — the property that lets
    XLA fuse everything into one pass."""

    vals: jax.Array  # (m, n_diags)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def blowup(self) -> float:
        return self.vals.size / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 config: SBlasConfig = DEFAULT) -> "DiaPlan":
        vals, offs = dia_arrays(A)
        return cls(jnp.asarray(vals, dtype), offs, A.shape, A.nnz)

    @classmethod
    def is_profitable(cls, A: CsrMatrix,
                      config: SBlasConfig = DEFAULT) -> bool:
        if A.nnz == 0:
            return False
        st = dia_stats(A)
        return (st["n_diags"] <= config.dia_max_diags
                and st["blowup"] <= config.dia_blowup_limit)


def _x_padded(plan: DiaPlan, x):
    """x extended so every diagonal's length-m slice is in range: slice j
    starts at offsets[j] + lead into [lead zeros | x | tail zeros]."""
    m, n = plan.shape
    lead = max(-min(plan.offsets), 0)
    tail = max(max(plan.offsets) + m - n, 0)
    return jnp.pad(x, (lead, tail)), lead


@jax.jit
def spmv_dia(plan: DiaPlan, x: jax.Array, alpha, beta,
             y: jax.Array) -> jax.Array:
    m = plan.shape[0]
    x_pad, lead = _x_padded(plan, x)
    acc = jnp.zeros(m, plan.vals.dtype)
    for j, off in enumerate(plan.offsets):
        xs = jax.lax.dynamic_slice(x_pad, (off + lead,), (m,))
        acc = acc + plan.vals[:, j] * xs
    return beta * y + alpha * acc


@jax.jit
def spmm_dia(plan: DiaPlan, B: jax.Array, alpha, beta,
             C: jax.Array) -> jax.Array:
    """C' = beta*C + alpha*A@B.  Correct for any DIA plan but re-reads B
    once per diagonal (module doc)."""
    m = plan.shape[0]
    k = B.shape[1]
    lead = max(-min(plan.offsets), 0)
    tail = max(max(plan.offsets) + m - plan.shape[1], 0)
    B_pad = jnp.pad(B, ((lead, tail), (0, 0)))
    acc = jnp.zeros((m, k), plan.vals.dtype)
    for j, off in enumerate(plan.offsets):
        Bs = jax.lax.dynamic_slice(B_pad, (off + lead, 0), (m, k))
        acc = acc + plan.vals[:, j:j + 1] * Bs
    return beta * C + alpha * acc
