"""Windowed-COO plan: tiled COO for unstructured SpMV/SpMM.

nnz are tiled TILE-at-a-time in CSR order; the planner assigns each tile
a 128-aligned row *window* of depth WINDOW that contains all its rows
(tiles are split when empty-row gaps would overflow the window).  The
plan stores each slot's column, destination row and value; each op
gathers x (or whole B rows) per slot, scales by the value, and reduces
into rows with one `segment_sum`.  Pad slots carry value 0 and add
nothing.

The layout was designed for hardware without a fast elementwise gather or
scatter, where the window bound let a one-hot matrix product stand in for
the scatter; under XLA both halves are plain gathers and scatter-adds,
which makes this plan a padded COO (no reference analog: cuSPARSE hides
the problem, spmm.h:146-149).
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

TILE = 512          # nnz per tile
WINDOW = 256        # row-window depth (two 128 blocks)


@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "rows", "vals"],
         meta_fields=["shape", "nnz", "n_tiles"])
@dataclasses.dataclass(frozen=True)
class WcooPlan:
    """Windowed COO layout (see module docstring), T = n_tiles.

    cols: (T*TILE,) i32   column of each slot
    rows: (T*TILE,) i32   destination row of each slot; inside a tile all
                          rows lie in one 128-aligned window of depth
                          WINDOW, and window starts are monotone in tile
                          order (pad slots sit at their window's start)
    vals: (T*TILE,)       values (pad slots are 0)
    """

    cols: jax.Array
    rows: jax.Array
    vals: jax.Array
    shape: Tuple[int, int]
    nnz: int
    n_tiles: int

    @property
    def fill_ratio(self) -> float:
        """Stored slots / true nnz (tile-split + padding overhead)."""
        return self.vals.shape[0] / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 config: SBlasConfig = DEFAULT, *,
                 min_tiles: int = 0) -> "WcooPlan":
        """`min_tiles` pads the tile count up to a shared static size (pad
        tiles carry val=0 anchored at the last window and contribute
        nothing) — used by the band-streaming/distributed layers so
        per-band plans share one shape and one compiled kernel."""
        np_val = np.dtype(jnp.dtype(dtype).name)
        arr = wcoo_arrays(A, min_tiles=min_tiles)
        return cls(
            cols=jnp.asarray(arr["cols"], jnp.int32),
            rows=jnp.asarray(arr["rows"], jnp.int32),
            vals=jnp.asarray(arr["vals"].astype(np_val), dtype),
            shape=A.shape, nnz=A.nnz, n_tiles=arr["n_tiles"])


def _tile_starts(rows: np.ndarray) -> list:
    """Greedy tiling of CSR-ordered entries: <= TILE entries per tile, all
    rows inside the 128-aligned window of depth WINDOW anchored at the
    tile's first row.  Returns the first entry of every tile."""
    # limit[i]: first j whose row leaves the window anchored at i
    anchors = ((rows >> 7) + WINDOW // 128) * 128
    limit = np.searchsorted(rows, anchors, side="left")
    starts, i = [], 0
    while i < len(rows):
        starts.append(i)
        i = min(i + TILE, int(limit[i]))
    return starts


def wcoo_tile_count(A: CsrMatrix) -> int:
    """Natural tile count of the windowed-COO layout — just the tiling,
    no array construction (the cheap probe the band layers use for
    shared static dims)."""
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), A.row_nnz)
    return max(len(_tile_starts(rows)), 1)


def wcoo_arrays(A: CsrMatrix, min_tiles: int = 0) -> dict:
    """Windowed-COO layout as host numpy arrays (kept numpy-pure so
    callers control placement — device HBM for single-chip plans, pinned
    host for the UM-analog band streamer)."""
    coo = A.to_coo()  # CSR order: rows ascending
    rows, col_ids, values = coo.row_idx, coo.col_idx, coo.values
    nnz = len(rows)
    starts = np.asarray(_tile_starts(rows) or [0], dtype=np.int64)
    T_real = len(starts)
    T = max(T_real, int(min_tiles))
    ends = np.concatenate([starts[1:], [nnz]])
    counts = np.pad(ends - starts, (0, T - T_real))

    # --- scatter nnz into (T, TILE) slots; pad slots point at their
    # tile's window start
    slot_tile = np.repeat(np.arange(T), counts)
    slot_pos = np.arange(nnz) - np.repeat(starts, counts[:T_real])
    window = np.zeros(T, dtype=np.int64)
    if nnz:
        window[:T_real] = (rows[starts] // 128) * 128
        # pad tiles (min_tiles) anchor at the LAST real window, keeping
        # the tile->window sequence monotone
        window[T_real:] = window[T_real - 1]
    vals = np.zeros((T, TILE), dtype=values.dtype)
    cols = np.zeros((T, TILE), dtype=np.int64)
    slot_rows = np.repeat(window[:, None], TILE, axis=1)
    if nnz:
        vals[slot_tile, slot_pos] = values
        cols[slot_tile, slot_pos] = col_ids
        slot_rows[slot_tile, slot_pos] = rows
    assert (slot_rows - window[:, None]).max(initial=0) < WINDOW

    return {
        "cols": cols.reshape(-1).astype(np.int32),
        "rows": slot_rows.reshape(-1).astype(np.int32),
        "vals": vals.reshape(-1),
        "n_tiles": T,
    }


@jax.jit
def spmv_wcoo(plan: WcooPlan, x: jax.Array, alpha, beta,
              y: jax.Array) -> jax.Array:
    # pad slots follow each tile's real entries, so the rows are not
    # sorted: an unsorted scatter-add, whose summation order varies
    # between runs on the GPU
    contrib = plan.vals * jnp.take(x, plan.cols, axis=0)
    ax = jax.ops.segment_sum(contrib, plan.rows,
                             num_segments=plan.shape[0])
    return beta * y + alpha * ax


# Transient budget for spmm_wcoo, in ELEMENTS (~1 GB of f32): bounds the
# gathered (T*TILE, kc) intermediate by scaling the K-chunk with the
# matrix size (a fixed kc would build multi-GB transients on large-nnz x
# large-K cases).  The chunks are over B columns, so each gather stays
# flat rather than inside a loop.
_K_BUDGET_ELEMS = 256 * 1024 * 1024


@partial(jax.jit, static_argnames=("k_chunk",))
def spmm_wcoo(plan: WcooPlan, B: jax.Array, alpha, beta, C: jax.Array,
              k_chunk: int = None) -> jax.Array:
    """SpMM with the same layout: whole B rows per slot, one scatter-add
    into C rows per K-chunk."""
    m, k = plan.shape[0], B.shape[1]
    T = plan.n_tiles
    kc = k_chunk or max(min(k, _K_BUDGET_ELEMS // max(T * TILE, 1)), 1)
    outs = []
    for k0 in range(0, k, kc):
        gathered = jnp.take(B[:, k0:k0 + kc], plan.cols, axis=0)
        outs.append(jax.ops.segment_sum(
            plan.vals[:, None] * gathered, plan.rows, num_segments=m))
    ab = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    return beta * C + alpha * ab
