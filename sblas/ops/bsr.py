"""Block-sparse (BELL: block-ELLPACK) plans and batched-matmul kernels.

This layout has no analog in the reference: instead of delegating
unstructured CSR to a gather machine (the reference hands it to cuSPARSE,
spmm.h:146-149), we re-block the matrix into dense (R x C) tiles and drive
SpMM as batched dense matmuls:

    C_blockrow += sum_s  A_block[brow, s] @ B_blocktile[bcol[brow, s]]

* gathers move whole (C x K) tiles (tens of KB) instead of single rows —
  gather overhead amortizes to nothing;
* the multiply itself is a batched (R x C) @ (C x K) contraction at full
  contraction width C=128, in f32 at Precision.HIGHEST;
* padding blocks (bcol=0, vals=0) keep shapes static.

The cost is zero-fill: a block is stored dense.  `BsrPlan.blowup` measures
stored/true nnz; `make_plan` only picks this layout when the structure is
block-friendly (banded/FEM matrices like the reference's s3dkq4m2
benchmark are; power-law web graphs are not).
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


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["vals", "bcol"],
         meta_fields=["shape", "nnz", "block"])
@dataclasses.dataclass(frozen=True)
class BsrPlan:
    """Block-ELL layout: every block-row padded to L block slots.

    vals: (n_brows, L, R, C) dense blocks (zero-filled)
    bcol: (n_brows, L) int32 block-column ids (padding slots point at
          block-column 0 with zero values)
    """

    vals: jax.Array
    bcol: jax.Array
    shape: Tuple[int, int]
    nnz: int
    block: Tuple[int, int]  # (R, C)

    @property
    def slots(self) -> int:
        return self.bcol.shape[1]

    @property
    def blowup(self) -> float:
        """Stored elements / true nnz (1.0 = perfectly dense blocks)."""
        return float(self.vals.size) / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 block: Tuple[int, int] = (128, 128),
                 config: SBlasConfig = DEFAULT) -> "BsrPlan":
        vals, bcol_arr = bell_arrays(A, block)
        return cls(jnp.asarray(vals, dtype), jnp.asarray(bcol_arr, jnp.int32),
                   A.shape, A.nnz, block)


def bell_arrays(A: CsrMatrix, block: Tuple[int, int] = (128, 128)):
    """Block-ELL layout as host numpy arrays: (vals (n_brows,L,R,C),
    bcol (n_brows,L)).  Numpy-pure so callers control placement."""
    R, C = block
    stats = bell_stats(A, block)
    n_brows, n_bcols, L = (stats["n_brows"], stats["n_bcols"],
                           stats["slots"])
    coo = A.to_coo()
    brow = coo.row_idx // R
    bcol = coo.col_idx // C
    # rank blocks within each block-row (blocks sorted by (brow, bcol))
    key = brow * n_bcols + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inverse = np.unique(key_s, return_inverse=True)
    u_brow = uniq // n_bcols
    # slot of each unique block within its block-row
    first_of_brow = np.searchsorted(u_brow, np.arange(n_brows))
    slot_of_uniq = np.arange(len(uniq)) - first_of_brow[u_brow]
    slot = np.empty(len(key), dtype=np.int64)
    slot[order] = slot_of_uniq[inverse]

    vals = np.zeros((n_brows, L, R, C), dtype=A.values.dtype)
    bcol_arr = np.zeros((n_brows, L), dtype=np.int64)
    vals[brow, slot, coo.row_idx % R, coo.col_idx % C] = coo.values
    bcol_arr[u_brow, slot_of_uniq] = uniq % n_bcols
    return vals, bcol_arr


def bell_stats(A: CsrMatrix, block: Tuple[int, int] = (128, 128)) -> dict:
    """Cheap structural probe: block counts and fill blowup without
    materializing the plan (used by the make_plan heuristic)."""
    R, C = block
    m, n = A.shape
    n_brows = max(_round_up(m, R) // R, 1)
    n_bcols = max(_round_up(n, C) // C, 1)
    coo = A.to_coo()
    key = (coo.row_idx // R) * n_bcols + (coo.col_idx // C)
    uniq = np.unique(key)
    counts = np.bincount(uniq // n_bcols, minlength=n_brows)
    L = max(int(counts.max()) if len(counts) else 1, 1)
    n_blocks_padded = n_brows * L
    return {
        "n_brows": n_brows,
        "n_bcols": n_bcols,
        "slots": L,
        "n_blocks": len(uniq),
        "blowup": n_blocks_padded * R * C / max(A.nnz, 1),
        "mean_blocks_per_brow": len(uniq) / n_brows,
    }


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _precision(dtype):
    """Dot precision: full f32 for float32 operands (the default lets the
    backend round inputs — to TF32 on the GPU — which misses the
    reference's 1e-3 verification bar; cuSPARSE computes true f32);
    default for bf16."""
    return (jax.lax.Precision.HIGHEST
            if dtype in (jnp.float32, jnp.float64) else
            jax.lax.Precision.DEFAULT)


def _b_blocks(plan: BsrPlan, B):
    """Zero-pad B's rows to the block grid and view as (n_bcols, C, K)."""
    C = plan.block[1]
    n_pad = _round_up(plan.shape[1], C)
    B_p = jnp.pad(B, ((0, n_pad - B.shape[0]), (0, 0)))
    return B_p.reshape(n_pad // C, C, B.shape[1])


def bsr_matmul(plan: BsrPlan, B):
    """A @ B via per-slot block gather + batched matmul.

    L is static and small for block-friendly matrices, so the slot loop is
    unrolled at trace time; each step gathers whole (C, K) tiles of B and
    contracts at full block width."""
    n_brows, L, R, _ = plan.vals.shape
    blocks = _b_blocks(plan, B)
    acc = jnp.zeros((n_brows, R, B.shape[1]), plan.vals.dtype)
    for s in range(L):
        gathered = jnp.take(blocks, plan.bcol[:, s], axis=0)  # (n_brows,C,K)
        acc = acc + jax.lax.dot_general(
            plan.vals[:, s], gathered,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=plan.vals.dtype,
            precision=_precision(plan.vals.dtype))
    return acc.reshape(n_brows * R, B.shape[1])[: plan.shape[0]]


@jax.jit
def spmm_bsr(plan: BsrPlan, B: jax.Array, alpha, beta,
             C: jax.Array) -> jax.Array:
    return beta * C + alpha * bsr_matmul(plan, B)


def bsr_matvec(plan: BsrPlan, x):
    """A @ x: per-slot gather of (C,) x-tiles + batched block matvec."""
    n_brows, L, R, Cb = plan.vals.shape
    n_pad = _round_up(plan.shape[1], Cb)
    x_p = jnp.pad(x, (0, n_pad - x.shape[0])).reshape(n_pad // Cb, Cb)
    acc = jnp.zeros((n_brows, R), plan.vals.dtype)
    for s in range(L):
        gathered = jnp.take(x_p, plan.bcol[:, s], axis=0)  # (n_brows, Cb)
        acc = acc + jax.lax.dot_general(
            plan.vals[:, s], gathered,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=plan.vals.dtype,
            precision=_precision(plan.vals.dtype))
    return acc.reshape(n_brows * R)[: plan.shape[0]]


@jax.jit
def spmv_bsr(plan: BsrPlan, x: jax.Array, alpha, beta,
             y: jax.Array) -> jax.Array:
    return beta * y + alpha * bsr_matvec(plan, x)
