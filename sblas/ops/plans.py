"""Device-side sparse-operand plans.

XLA wants static shapes; sparse data is ragged.  A *plan* is the bridge: a
host-side preprocessing step that lays a CSR matrix out as fixed-shape,
tile-aligned device arrays (padded and, where useful, re-blocked), so
every downstream op is a pure, jittable function of jax.Arrays.

This replaces the reference's device-pointer mirror fields inside the
containers (`csrRowPtr_gpu[]` etc., matrix.h:287-295) with immutable pytrees,
and its format choice (always CSR into cuSPARSE) with several layouts:

* `CooPlan` — row/col/val triplets, padded to the nnz tile; consumed by
  gather + `segment_sum` kernels.  Works for any sparsity structure.
* `EllPlan` — ELLPACK (m_pad x L) slots; gather-only (no scatter), the
  fast path when row occupancy is balanced.
* Block-sparse (BELL), diagonal (DIA) and routed plans live in
  `bsr.py` / `dia.py` / `rspmv.py`.

Indices are int32 on device.
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


def ell_arrays(A: CsrMatrix):
    """ELLPACK layout as host numpy arrays: (cols, vals), each (m_pad, L).

    Kept numpy-pure so callers control placement (device HBM for single-chip
    plans, pinned host for the UM-analog band streamer)."""
    m, _ = A.shape
    row_nnz = A.row_nnz
    L = max(int(row_nnz.max()) if m else 1, 1)
    m_pad = _round_up(max(m, 1), 8)
    cols = np.zeros((m_pad, L), dtype=np.int64)
    vals = np.zeros((m_pad, L), dtype=A.values.dtype)
    # slot index of each nnz within its row: position - row start
    slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.row_ptr[:-1], row_nnz)
    row_of = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    cols[row_of, slot] = A.col_idx
    vals[row_of, slot] = A.values
    return cols, vals


@partial(jax.tree_util.register_dataclass,
         data_fields=["rows", "cols", "vals"],
         meta_fields=["shape", "nnz"])
@dataclasses.dataclass(frozen=True)
class CooPlan:
    """Padded, row-sorted COO triplets.

    Padding entries carry val=0 and point at the last row/col 0 so the array
    stays row-sorted (lets XLA use the sorted-scatter path) and contributes
    nothing."""

    rows: jax.Array  # (nnz_pad,) int32, sorted ascending
    cols: jax.Array  # (nnz_pad,) int32
    vals: jax.Array  # (nnz_pad,) dtype
    shape: Tuple[int, int]
    nnz: int

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 config: SBlasConfig = DEFAULT) -> "CooPlan":
        coo = A.to_coo()
        nnz_pad = max(_round_up(max(A.nnz, 1), config.nnz_tile), config.nnz_tile)
        pad = nnz_pad - A.nnz
        rows = np.concatenate(
            [coo.row_idx, np.full(pad, A.height - 1, dtype=np.int64)])
        cols = np.concatenate([coo.col_idx, np.zeros(pad, dtype=np.int64)])
        vals = np.concatenate(
            [coo.values, np.zeros(pad, dtype=coo.values.dtype)])
        return cls(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
                   jnp.asarray(vals, dtype), A.shape, A.nnz)


@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "vals"],
         meta_fields=["shape", "nnz"])
@dataclasses.dataclass(frozen=True)
class EllPlan:
    """ELLPACK layout: every row padded to L slots (col 0, val 0).

    Rows are padded to a multiple of 8.  The ops on this plan are pure
    gather+multiply+reduce — no scatter.
    """

    cols: jax.Array  # (m_pad, L) int32
    vals: jax.Array  # (m_pad, L) dtype
    shape: Tuple[int, int]
    nnz: int

    @property
    def slots(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 config: SBlasConfig = DEFAULT) -> "EllPlan":
        cols, vals = ell_arrays(A)
        return cls(jnp.asarray(cols, jnp.int32), jnp.asarray(vals, dtype),
                   A.shape, A.nnz)

    @classmethod
    def is_profitable(cls, A: CsrMatrix,
                      config: SBlasConfig = DEFAULT) -> bool:
        """ELL stores m * max_row_nnz padded slots; profitable only when
        that stays within ell_blowup_limit of the true nnz.  This is the
        exact padded-slot form — the earlier `max_deg <= limit *
        max(mean, 1.0)` floored the mean at 1, which let a 500k-row /
        5k-nnz near-empty matrix "qualify" and run far slower than COO:
        with mean << 1 the padding is m slots per max-degree unit, not
        nnz-proportional."""
        if A.nnz == 0 or A.height == 0:
            return False
        padded = float(A.row_nnz.max()) * A.height
        return padded <= config.ell_blowup_limit * A.nnz
