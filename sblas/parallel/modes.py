"""Distributed SpMM/SpMV execution strategies over a device mesh.

Re-design of the reference's two multi-GPU strategies:

* **mode 1 — partition dense B** (`sblas_spmm_csr_v1`, spmm.h:83-161):
  A replicated, B/C column-sharded, zero inter-device communication.
  Here: `shard_map` with B/C split on the mesh axis, plan replicated.

* **mode 2 — partition sparse A** (`sblas_spmm_csr_v2`, spmm.h:163-284, and
  `sblas_spmv_csr_v1`, spmv.h:35-139): A nnz-segmented with row straddling,
  partial C per device, NCCL all-reduce of the *full* C buffer
  (spmm.h:260-262).  Here: each shard segment-sums its COO chunk into a
  full-height partial and the overlap-add happens in one XLA collective —
  `psum` for exact reference semantics (replicated result), or
  `psum_scatter` to keep the result row-sharded and cut the collective cost
  by n_shards (a direct improvement on the reference's full-buffer
  all-reduce; SURVEY.md §5).

* **halo SpMV** (no reference analog): contiguous
  row-block partition of a square A with x sharded the same way; each shard
  fetches only neighbor x blocks via `lax.ppermute` over the device links
  instead of replicating x — the right pattern for banded/FEM matrices.

The reference's per-call NCCL communicator setup/teardown
(ncclCommInitRank inside an omp region, spmm.h:179-189) has no equivalent:
collectives are compiled into the jitted program.  Compiled programs are
cached per (mesh, axis, strategy) — repeat calls with same-shaped operands
hit XLA's jit cache instead of rebuilding the SPMD program (the reference
re-creates its comms and cuSPARSE descriptors on every call).

All entry points accept a `reduce=` choice and return global `jax.Array`s;
alpha/beta epilogues are fused into the same program (vs the reference's
separate plusDenseMatrixGPU launch, spmm.h:283).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.bsr import BsrPlan, spmm_bsr
from ..ops.dia import DiaPlan, spmm_dia
from ..ops.plans import EllPlan
from ..ops.spmm import segment_spmm, spmm_ell
from ..ops.spmv import segment_spmv
from ..ops.wcoo import WcooPlan, spmm_wcoo
from ..partition import CooSegments, RowBlocks
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import DEFAULT_AXIS


def _pad_rows(x, m_pad):
    pad = m_pad - x.shape[0]
    if pad == 0:
        return x
    return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))


# ---------------------------------------------------------------------------
# Cached program builders: one compiled SPMD program per (mesh, axis,
# strategy); XLA's jit cache handles per-shape specialization below that.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mode1_program(mesh: Mesh, axis: str):
    def fn(plan, B_blk, C_blk, alpha, beta):
        if isinstance(plan, BsrPlan):
            return spmm_bsr(plan, B_blk, alpha, beta, C_blk)
        if isinstance(plan, DiaPlan):
            return spmm_dia(plan, B_blk, alpha, beta, C_blk)
        if isinstance(plan, WcooPlan):
            return spmm_wcoo(plan, B_blk, alpha, beta, C_blk)
        if isinstance(plan, EllPlan):
            return spmm_ell(plan, B_blk, alpha, beta, C_blk)
        ab = segment_spmm(plan.rows, plan.cols, plan.vals, B_blk,
                          plan.shape[0])
        return beta * C_blk + alpha * ab

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(None, axis), P(None, axis), P(), P()),
        out_specs=P(None, axis),
        check_vma=True))


@functools.lru_cache(maxsize=None)
def _mode2_spmm_program(mesh: Mesh, axis: str, reduce: str):
    n = mesh.shape[axis]

    def fn(segs, B, C, alpha, beta):
        m = segs.shape[0]
        partial_c = segment_spmm(segs.rows[0], segs.cols[0], segs.vals[0],
                                 B, m)
        if reduce == "psum":
            return beta * C + alpha * lax.psum(partial_c, axis)
        mine = lax.psum_scatter(_pad_rows(partial_c, -(-m // n) * n), axis,
                                scatter_dimension=0, tiled=True)
        return beta * C + alpha * mine

    c_spec = P() if reduce == "psum" else P(axis, None)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis, None), P(), c_spec, P(), P()),
        out_specs=c_spec))


@functools.lru_cache(maxsize=None)
def _mode2_spmv_program(mesh: Mesh, axis: str, reduce: str):
    n = mesh.shape[axis]

    def fn(segs, x, y, alpha, beta):
        m = segs.shape[0]
        partial_y = segment_spmv(segs.rows[0], segs.cols[0], segs.vals[0],
                                 x, m)
        if reduce == "psum":
            return beta * y + alpha * lax.psum(partial_y, axis)
        mine = lax.psum_scatter(_pad_rows(partial_y, -(-m // n) * n), axis,
                                scatter_dimension=0, tiled=True)
        return beta * y + alpha * mine

    y_spec = P() if reduce == "psum" else P(axis)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis, None), P(), y_spec, P(), P()),
        out_specs=y_spec))


@functools.lru_cache(maxsize=None)
def _mode2_spmm_nocomm_program(mesh: Mesh, axis: str):
    def fn(segs, B):
        return segment_spmm(segs.rows[0], segs.cols[0], segs.vals[0], B,
                            segs.shape[0])

    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(axis, None), P()),
        out_specs=P(axis, None)))


@functools.lru_cache(maxsize=None)
def _mode2_spmv_nocomm_program(mesh: Mesh, axis: str):
    def fn(segs, x):
        return segment_spmv(segs.rows[0], segs.cols[0], segs.vals[0], x,
                            segs.shape[0])

    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(axis, None), P()), out_specs=P(axis)))


def spmm_mode2_nocomm(segs: CooSegments, B, mesh: Mesh,
                      axis: str = DEFAULT_AXIS) -> jax.Array:
    """Diagnostic: mode-2 per-shard partials WITHOUT the sum collective.
    Drivers time this against the full run to report the comm/compute
    phase split (the reference prints per-GPU NCCL all-reduce time,
    spmm.h:258-271); values are the unreduced partials — timing only."""
    return _mode2_spmm_nocomm_program(mesh, axis)(segs, B)


def spmv_dist_nocomm(segs: CooSegments, x, mesh: Mesh,
                     axis: str = DEFAULT_AXIS) -> jax.Array:
    """Diagnostic twin of `spmv_dist` without the collective
    (spmv.h:112-128 analog for phase reporting)."""
    return _mode2_spmv_nocomm_program(mesh, axis)(segs, x)


@functools.lru_cache(maxsize=None)
def _halo_spmv_program(mesh: Mesh, axis: str):
    n = mesh.shape[axis]

    def fn(blocks, x_blk, y_blk, alpha, beta):
        r = blocks.rows_per_shard
        cols, vals, lrows = (blocks.cols[0], blocks.vals[0],
                             blocks.local_rows[0])
        idx = lax.axis_index(axis)
        # pull left and right neighbor x blocks
        from_left = lax.ppermute(x_blk, axis,
                                 perm=[(i, (i + 1) % n) for i in range(n)])
        from_right = lax.ppermute(x_blk, axis,
                                  perm=[(i, (i - 1) % n) for i in range(n)])
        x_ext = jnp.concatenate([from_left, x_blk, from_right])  # (3r,)
        # global col -> offset into x_ext: col - (block_start - r); clip is
        # a no-op for valid plans (halo <= r checked by the wrapper)
        local_cols = jnp.clip(cols - (idx * r - r), 0, 3 * r - 1)
        partial_y = segment_spmv(lrows, local_cols, vals, x_ext, r)
        return beta * y_blk + alpha * partial_y

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis), P(), P()),
        out_specs=P(axis)))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def spmm_mode1(plan, B, alpha, beta, C, mesh: Mesh,
               axis: str = DEFAULT_AXIS) -> jax.Array:
    """C' = beta*C + alpha*A@B with B/C column-sharded, A replicated.

    Functional equivalent of sblas_spmm_csr_v1 (spmm.h:83-161): each device
    multiplies the full A against its K/n column slice; no collective.
    K is zero-padded to a multiple of the shard count (the reference gives
    the last GPU a ragged slice instead, matrix.h:563-567)."""
    n = mesh.shape[axis]
    require(B.shape[0] == plan.shape[1], ShapeError,
            f"A width {plan.shape[1]} != B height {B.shape[0]}")
    k = B.shape[1]
    k_pad = -(-k // n) * n
    B_p = jnp.pad(B, ((0, 0), (0, k_pad - k)))
    C_p = jnp.pad(C, ((0, 0), (0, k_pad - k)))
    out = _mode1_program(mesh, axis)(plan, B_p, C_p, alpha, beta)
    return out[:, :k]


def spmm_mode2(segs: CooSegments, B, alpha, beta, C, mesh: Mesh,
               axis: str = DEFAULT_AXIS, reduce: str = "psum") -> jax.Array:
    """C' = beta*C + alpha*A@B with A nnz-segmented (rows may straddle
    shards), B replicated.

    `reduce="psum"` reproduces the reference's all-reduce of the full
    replicated C_copy (spmm.h:182-183, 260-262) followed by the fused
    alpha/beta fold (spmm.h:283).  `reduce="psum_scatter"` returns the same
    values but keeps C row-sharded, moving 1/n of the bytes per link."""
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")
    n = mesh.shape[axis]
    require(segs.n_shards == n, PartitionError,
            f"segments built for {segs.n_shards} shards, mesh has {n}")
    require(B.shape[0] == segs.shape[1], ShapeError,
            f"A width {segs.shape[1]} != B height {B.shape[0]}")
    m = segs.shape[0]
    prog = _mode2_spmm_program(mesh, axis, reduce)
    if reduce == "psum":
        return prog(segs, B, C, alpha, beta)
    m_pad = -(-m // n) * n
    out = prog(segs, B, _pad_rows(C, m_pad), alpha, beta)
    return out[:m]


def spmv_dist(segs: CooSegments, x, alpha, beta, y, mesh: Mesh,
              axis: str = DEFAULT_AXIS, reduce: str = "psum") -> jax.Array:
    """y' = beta*y + alpha*A@x with A nnz-segmented, x replicated.

    Functional equivalent of sblas_spmv_csr_v1 (spmv.h:35-139): per-shard
    partial y (spmv.h:85-91), one sum collective (spmv.h:115-118), fused
    fold (spmv.h:138)."""
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")
    n = mesh.shape[axis]
    require(segs.n_shards == n, PartitionError,
            f"segments built for {segs.n_shards} shards, mesh has {n}")
    require(x.shape[0] == segs.shape[1], ShapeError,
            f"A width {segs.shape[1]} != x length {x.shape[0]}")
    m = segs.shape[0]
    prog = _mode2_spmv_program(mesh, axis, reduce)
    if reduce == "psum":
        return prog(segs, x, y, alpha, beta)
    m_pad = -(-m // n) * n
    out = prog(segs, x, _pad_rows(y, m_pad), alpha, beta)
    return out[:m]


def spmv_halo(blocks: RowBlocks, x, alpha, beta, y, mesh: Mesh,
              axis: str = DEFAULT_AXIS) -> jax.Array:
    """y' = beta*y + alpha*A@x with A row-block-partitioned and x sharded
    the same way; each shard receives only its neighbors' x blocks over the
    device links (`lax.ppermute`), never the full vector.

    Requires the matrix's column footprint per block to reach at most one
    block left/right (checked from the planner's halo metadata) — the
    natural case for banded/FEM matrices.  Wider reach -> use spmv_dist."""
    n = mesh.shape[axis]
    require(blocks.n_shards == n, PartitionError,
            f"blocks built for {blocks.n_shards} shards, mesh has {n}")
    r = blocks.rows_per_shard
    require(blocks.halo_left <= r and blocks.halo_right <= r, PartitionError,
            f"column footprint (halo {blocks.halo_left}/{blocks.halo_right})"
            f" exceeds one block ({r}); use spmv_dist instead")
    m = blocks.shape[0]
    m_pad = r * n
    out = _halo_spmv_program(mesh, axis)(
        blocks, _pad_rows(x, m_pad), _pad_rows(y, m_pad), alpha, beta)
    return out[:m]
