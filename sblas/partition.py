"""nnz-balanced partition planner for distributed sparse ops.

Rebuild of the reference's `CsrSparseMatrix::sync2gpu(n_gpu,
segment)` partitioner (matrix.h:356-395): split the nnz range into
`ceil(nnz/n)`-sized contiguous chunks (matrix.h:360), find each chunk's
start/stop rows by binary search (vectorized replacement of
`csr_findRowIdxUsingNnzIdx`, utility.h:292-300), and allow **rows to
straddle shard boundaries** — partial row results are summed by the
all-reduce, exactly the reference's overlap-add contract
(matrix.h:443-445 + spmm.h:260-262).

Where the reference emits per-GPU rebased CSR pointers of *varying* length,
XLA needs one static shape for all shards: the planner emits **stacked,
padded COO segments** — `(n_shards, seg_nnz)` arrays with global row ids —
which is exactly what a `shard_map`ed segment-sum kernel consumes.  Padding
entries carry val=0 and the shard's last real row id, preserving per-shard
row-sortedness.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT, SBlasConfig
from .containers import CsrMatrix
from .utils.errors import PartitionError, require


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["rows", "cols", "vals"],
         meta_fields=["shape", "nnz", "n_shards", "starting_rows",
                      "stopping_rows"])
@dataclasses.dataclass(frozen=True)
class CooSegments:
    """Stacked nnz-balanced COO shards of one CSR matrix.

    `rows` hold **global** row indices (the reference instead rebases each
    shard's rowPtr and offsets the output pointer by `starting_row_gpu`,
    spmm.h:227; with global ids + segment_sum the offset bookkeeping
    disappears and psum/psum_scatter implement the same overlap-add)."""

    rows: jax.Array  # (n_shards, seg_nnz) int32, row-sorted per shard
    cols: jax.Array  # (n_shards, seg_nnz) int32
    vals: jax.Array  # (n_shards, seg_nnz) dtype
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    starting_rows: Tuple[int, ...]   # first (possibly partial) row per shard
    stopping_rows: Tuple[int, ...]   # last row touched per shard (inclusive)

    @property
    def seg_nnz(self) -> int:
        return self.rows.shape[1]


def partition_nnz_balanced(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                           config: SBlasConfig = DEFAULT) -> CooSegments:
    """Split A's nnz into `n_shards` equal contiguous chunks.

    Chunking matches matrix.h:360 (`avg_nnz = ceil(nnz / n_gpu)`); the final
    shard takes the remainder.  Every shard is padded to the same
    tile-aligned length."""
    require(n_shards >= 1, PartitionError, f"n_shards must be >=1, got {n_shards}")
    m, _ = A.shape
    coo = A.to_coo()  # row-sorted by construction
    avg = -(-max(A.nnz, 1) // n_shards)  # ceil, like the reference
    seg_nnz = _round_up(avg, config.nnz_tile)

    rows = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    cols = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    vals = np.zeros((n_shards, seg_nnz), dtype=A.values.dtype)
    starting, stopping = [], []
    for s in range(n_shards):
        lo = min(s * avg, A.nnz)
        hi = min(lo + avg, A.nnz)
        k = hi - lo
        if k > 0:
            rows[s, :k] = coo.row_idx[lo:hi]
            cols[s, :k] = coo.col_idx[lo:hi]
            vals[s, :k] = coo.values[lo:hi]
            last_row = int(coo.row_idx[hi - 1])
            first_row = int(coo.row_idx[lo])
        else:  # empty shard (more shards than nnz)
            last_row = first_row = m - 1 if m else 0
        rows[s, k:] = last_row  # keeps per-shard rows sorted
        starting.append(first_row)
        stopping.append(last_row)

    return CooSegments(
        rows=jnp.asarray(rows, jnp.int32),
        cols=jnp.asarray(cols, jnp.int32),
        vals=jnp.asarray(vals, dtype),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        starting_rows=tuple(starting), stopping_rows=tuple(stopping))


def partition_report(segs: CooSegments) -> str:
    """Human-readable shard stats (analog of the reference's per-shard
    printf, matrix.h:388-390)."""
    lines = []
    avg = -(-max(segs.nnz, 1) // segs.n_shards)
    for s in range(segs.n_shards):
        lo = min(s * avg, segs.nnz)
        hi = min(lo + avg, segs.nnz)
        lines.append(f"shard {s}: rows [{segs.starting_rows[s]}, "
                     f"{segs.stopping_rows[s]}], nnz {hi - lo} "
                     f"(padded {segs.seg_nnz})")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Row-contiguous partition for the halo-exchange SpMV:
# rows (not nnz positions) are assigned whole to shards, nnz-balanced via
# the row_ptr, so each shard owns a contiguous row block and a matching
# x/y block.  No row straddling here by construction.
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["cols", "vals", "local_rows"],
         meta_fields=["shape", "nnz", "n_shards", "rows_per_shard",
                      "halo_left", "halo_right"])
@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """Contiguous row-block shards with halo metadata.

    Shard s owns rows [s*rows_per_shard, (s+1)*rows_per_shard) of the
    row-padded matrix.  `cols` are global column ids; `halo_left/right`
    give, over all shards, the max reach of columns beyond the owned block
    (in units of rows/elements), so the x-vector halo exchange can be sized
    statically."""

    cols: jax.Array        # (n_shards, seg_nnz) int32, global columns
    vals: jax.Array        # (n_shards, seg_nnz) dtype
    local_rows: jax.Array  # (n_shards, seg_nnz) int32, row - shard_base
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int


def partition_row_blocks(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                         config: SBlasConfig = DEFAULT) -> RowBlocks:
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    require(A.shape[0] == A.shape[1], PartitionError,
            "halo SpMV requires a square matrix (x and y share the blocking)")
    m = A.shape[0]
    rows_per_shard = _round_up(-(-m // n_shards), 8)
    m_pad = rows_per_shard * n_shards

    seg_nnz_raw = 1
    per_shard = []
    for s in range(n_shards):
        r0 = min(s * rows_per_shard, m)
        r1 = min((s + 1) * rows_per_shard, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        per_shard.append((r0, r1, lo, hi))
        seg_nnz_raw = max(seg_nnz_raw, hi - lo)
    seg_nnz = _round_up(seg_nnz_raw, config.nnz_tile)

    cols = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    vals = np.zeros((n_shards, seg_nnz), dtype=A.values.dtype)
    lrow = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    halo_l = halo_r = 0
    row_of = np.repeat(np.arange(m, dtype=np.int64), A.row_nnz)
    for s, (r0, r1, lo, hi) in enumerate(per_shard):
        k = hi - lo
        if k:
            cols[s, :k] = A.col_idx[lo:hi]
            vals[s, :k] = A.values[lo:hi]
            lrow[s, :k] = row_of[lo:hi] - r0
            halo_l = max(halo_l, int(max(r0 - A.col_idx[lo:hi].min(), 0)))
            halo_r = max(halo_r, int(max(A.col_idx[lo:hi].max() + 1
                                         - (r0 + rows_per_shard), 0)))
        lrow[s, k:] = (r1 - r0 - 1) if r1 > r0 else 0
        cols[s, k:] = min(r0, m - 1) if m else 0

    return RowBlocks(
        cols=jnp.asarray(cols, jnp.int32),
        vals=jnp.asarray(vals, dtype),
        local_rows=jnp.asarray(lrow, jnp.int32),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        rows_per_shard=rows_per_shard,
        halo_left=halo_l, halo_right=halo_r)
