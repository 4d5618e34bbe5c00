"""Distributed modes over per-shard *fast* plans.

The baseline distributed modes (`modes.py`) run the tier-0 COO segment-sum
per shard — the faithful functional translation of the reference, which
delegates per-GPU compute to cuSPARSE (spmm.h:146-149) and so never has
this problem.  Here each shard gets the same fast single-chip layouts the
framework uses on one device (BELL, ELL, DIA, windowed COO), built with one COMMON set
of static shapes and stacked along a leading shard axis so a single
`shard_map` program serves every shard:

* `partition_row_plans`  — nnz-balanced *row-granular* split (no row
  straddling: whole rows move to shards; the reference's straddling
  overlap-add semantics live on in `partition_nnz_balanced`+`modes.py`),
  then one plan per shard padded to shared dims and `tree_map`-stacked.
* `spmm_mode2_planned` / `spmv_dist_planned` — mode-2 (partition sparse A)
  with per-shard plan kernels and `psum` / `psum_scatter` of partial C.
* `spmv_halo_planned` — the halo-exchange SpMV with a per-shard DIA plan
  over the [left | own | right] x window: the banded multi-chip path runs
  the same shift-and-FMA kernel that wins on one chip.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops.bsr import BsrPlan, bell_arrays, bell_stats, spmm_bsr, spmv_bsr
from ..ops.dia import DiaPlan, dia_arrays, spmm_dia, spmv_dia
from ..ops.plans import CooPlan, EllPlan, ell_arrays
from ..ops.spmm import spmm_coo, spmm_ell
from ..ops.spmv import spmv_coo, spmv_ell
from ..partition import partition_row_blocks
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import DEFAULT_AXIS


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(jax.tree_util.register_dataclass,
         data_fields=["plan", "row_offsets"],
         meta_fields=["shape", "nnz", "n_shards", "band_rows", "kind"])
@dataclasses.dataclass(frozen=True)
class RowPlanShards:
    """Stacked per-shard plans: every data leaf of `plan` carries a leading
    (n_shards,) axis; `plan`'s meta describes the (identical) local shard
    shape (band_rows x n).  `row_offsets[s]` is shard s's first global row."""

    plan: object           # stacked BsrPlan | EllPlan | DiaPlan
    row_offsets: jax.Array  # (n_shards, 1) int32
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    band_rows: int
    kind: str


def _row_boundaries(A: CsrMatrix, n_shards: int) -> np.ndarray:
    """Row-granular nnz-balanced boundaries (n_shards+1,)."""
    targets = (np.arange(1, n_shards) * (A.nnz / n_shards)).astype(np.int64)
    cuts = np.searchsorted(A.row_ptr[1:-1], targets, side="left") + 1 \
        if A.height > 1 else np.zeros(n_shards - 1, np.int64)
    cuts = np.clip(cuts, 0, A.height)
    return np.concatenate([[0], np.sort(cuts), [A.height]]).astype(np.int64)


def _local_csr(A: CsrMatrix, r0: int, r1: int, band_rows: int,
               col_shift: int = 0, width: int = None) -> CsrMatrix:
    """Rows [r0, r1) of A as a (band_rows, width) matrix, columns shifted."""
    lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
    rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                         np.full(band_rows - (r1 - r0), hi - lo,
                                 dtype=A.row_ptr.dtype)])
    return CsrMatrix(rp, A.col_idx[lo:hi] + col_shift, A.values[lo:hi],
                     (band_rows, width if width is not None else A.shape[1]))


def _union_offsets(subs):
    """Sorted union of occupied diagonals over shard submatrices (shards
    must share one static offset list to stack).  One dia_stats probe
    per shard (the previous inline form converted each shard to COO
    twice on the single-core host)."""
    from ..ops.dia import dia_stats
    offs = {int(o) for sub in subs for o in dia_stats(sub)["offsets"]}
    return sorted(offs or {0})


def _stack_plans(plans):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *plans)


def _unstack(plan):
    return jax.tree_util.tree_map(lambda a: a[0], plan)


def pick_shard_kind(A: CsrMatrix, config: SBlasConfig = DEFAULT) -> str:
    """Plan-kind heuristic shared by the shard partitioners: BELL when the
    global structure is block-friendly, ELL when row occupancy is balanced
    (same `EllPlan.is_profitable` blowup guard as `make_plan`),
    windowed-COO otherwise.  Like `make_plan`, it never picks the routed
    engine (pass kind="routed" to force it)."""
    if (bell_stats(A, config.bsr_block)["blowup"]
            <= config.bsr_blowup_limit):
        return "bsr"
    if EllPlan.is_profitable(A, config):
        return "ell"
    return "wcoo"


def shared_routed_sizes(sizes):
    """Element-wise maxima of per-shard `routed_shard_sizes` probes,
    with the stack depth CORRECTED for the shared overflow appendix:
    padding a shard's appendix up to the shared slot count adds
    depth-1 pad blocks, so a shard whose natural stack was the deepest
    but whose appendix was small can exceed the naive max-S probe
    (observed: 513 vs 512 rows -> stacked-plan shape divergence)."""
    tg = max(z[0] for z in sizes)
    pr = max(z[2] for z in sizes)
    sk = max(z[3] for z in sizes)
    sk_blocks = _round_up(sk, 128) // 128 if sk else 0
    sr = max(z[1] + (sk_blocks - (_round_up(z[3], 128) // 128
                                  if z[3] else 0))
             for z in sizes)
    return tg, sr, pr, sk


def build_stacked_plans(locals_, kind: str, band_rows: int, width: int,
                        nnz: int, dtype, config: SBlasConfig):
    """Per-shard fast plans over identically-shaped (band_rows, width)
    local CSR matrices, padded to one COMMON set of static dims and
    `tree_map`-stacked along a leading shard axis so a single `shard_map`
    program serves every shard.  Returns (stacked_plan, kind) — `kind`
    may degrade (wcoo -> coo) when tile-splitting blows up.

    Shared by `partition_row_plans` (mode-2 row shards) and
    `partition_xfoot` (footprint-compressed x-exchange shards)."""
    if kind == "routed":
        # shared static sizes make every static field — and hence the
        # route-layer schedules — equal, so the plans tree-stack
        from ..ops.rspmv import RoutedPlan, routed_shard_sizes
        sizes = [routed_shard_sizes(sub, config) for sub in locals_]
        tg, sr, pr, sk = shared_routed_sizes(sizes)
        plans = [dataclasses.replace(
            RoutedPlan.from_csr(sub, dtype=dtype, config=config,
                                min_gtiles=tg, min_srows=sr, min_prows=pr,
                                min_sranks=sk),
            nnz=nnz)
            for sub in locals_]
        require(len({p.schedule for p in plans}) == 1
                and len({p.unrank_schedule for p in plans}) == 1
                and len({p.xroute_schedule for p in plans}) == 1,
                PartitionError, "routed shard schedules diverged despite "
                "shared static sizes (planner bug)")
        return _stack_plans(plans), kind
    if kind == "bsr":
        raw = [bell_arrays(sub, config.bsr_block) for sub in locals_]
        L = max(v.shape[1] for v, _ in raw)
        plans = []
        for vals, bcol in raw:
            vals = np.pad(vals, ((0, 0), (0, L - vals.shape[1]),
                                 (0, 0), (0, 0)))
            bcol = np.pad(bcol, ((0, 0), (0, L - bcol.shape[1])))
            plans.append(BsrPlan(jnp.asarray(vals, dtype),
                                 jnp.asarray(bcol, jnp.int32),
                                 (band_rows, width), nnz,
                                 config.bsr_block))
    elif kind == "ell":
        raw = [ell_arrays(sub) for sub in locals_]
        L = max(c.shape[1] for c, _ in raw)
        plans = []
        for cols, vals in raw:
            cols = np.pad(cols, ((0, 0), (0, L - cols.shape[1])))
            vals = np.pad(vals, ((0, 0), (0, L - vals.shape[1])))
            plans.append(EllPlan(jnp.asarray(cols, jnp.int32),
                                 jnp.asarray(vals, dtype),
                                 (band_rows, width), nnz))
    elif kind == "dia":
        offs = _union_offsets(locals_)
        plans = []
        for sub in locals_:
            vals, offs_t = dia_arrays(sub, offsets=offs, n_rows=band_rows)
            plans.append(DiaPlan(jnp.asarray(vals, dtype), offs_t,
                                 (band_rows, width), nnz))
    elif kind in ("wcoo", "coo"):
        # per-shard windowed-COO (the unstructured workhorse), or plain
        # COO segments — built by the same machinery as the UM band layer
        # (shared static dims; wcoo falls back to coo automatically when
        # tile-splitting blows up)
        from ..memory.host import build_band_plan, probe_band_dims
        kind, dim = probe_band_dims(locals_, kind, nnz, config)
        plans = [build_band_plan(sub, kind, dim, band_rows, width,
                                 nnz, dtype, config, put=jnp.asarray)
                 for sub in locals_]
    else:
        raise PartitionError(f"unknown plan kind {kind!r}")
    return _stack_plans(plans), kind


def partition_row_plans(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                        kind: str = None,
                        config: SBlasConfig = DEFAULT) -> RowPlanShards:
    """nnz-balanced row-granular shards, each laid out as a fast plan.

    `kind` in {"bsr", "ell", "dia", "routed", "wcoo", "coo", None}; None
    picks by `pick_shard_kind` (a power-law shard must NOT allocate
    band_rows x max_row_nnz ELL slots; RoutedPlan is SpMV-only)."""
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    bounds = _row_boundaries(A, n_shards)
    band_rows = _round_up(int(np.max(bounds[1:] - bounds[:-1])) or 1, 128)

    if kind is None:
        kind = pick_shard_kind(A, config)
    locals_ = [_local_csr(A, int(bounds[s]), int(bounds[s + 1]), band_rows)
               for s in range(n_shards)]
    stacked, kind = build_stacked_plans(locals_, kind, band_rows,
                                        A.shape[1], A.nnz, dtype, config)
    return RowPlanShards(
        plan=stacked,
        row_offsets=jnp.asarray(bounds[:-1], jnp.int32).reshape(-1, 1),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        band_rows=band_rows, kind=kind)


def _local_spmm(kind, plan, B):
    from ..ops.wcoo import spmm_wcoo
    z = jnp.zeros((plan.shape[0], B.shape[1]), plan.vals.dtype)
    fn = {"bsr": spmm_bsr, "ell": spmm_ell, "dia": spmm_dia,
          "coo": spmm_coo, "wcoo": spmm_wcoo}[kind]
    return fn(plan, B, 1.0, 0.0, z)


def _local_spmv(kind, plan, x):
    from ..ops.rspmv import spmv_routed
    from ..ops.wcoo import spmv_wcoo
    val_dtype = (plan.gvals if kind == "routed" else plan.vals).dtype
    z = jnp.zeros(plan.shape[0], val_dtype)
    fn = {"bsr": spmv_bsr, "ell": spmv_ell, "dia": spmv_dia,
          "coo": spmv_coo, "routed": spmv_routed,
          "wcoo": spmv_wcoo}[kind]
    return fn(plan, x, 1.0, 0.0, z)


@functools.lru_cache(maxsize=None)
def _mode2p_spmm_program(mesh: Mesh, axis: str, reduce: str, kind: str,
                         m: int, band_rows: int):
    n = mesh.shape[axis]
    m_full = _round_up(m + band_rows, n * 128)

    def fn(shards, B, C, alpha, beta):
        plan = _unstack(shards.plan)
        local = _local_spmm(kind, plan, B)          # (band_rows, k)
        partial_c = jnp.zeros((m_full, B.shape[1]), local.dtype)
        off = shards.row_offsets[0, 0]
        partial_c = lax.dynamic_update_slice(
            partial_c, local, (off, jnp.zeros((), off.dtype)))
        if reduce == "psum":
            return beta * C + alpha * lax.psum(partial_c, axis)[:m]
        mine = lax.psum_scatter(partial_c, axis, scatter_dimension=0,
                                tiled=True)
        return beta * C + alpha * mine

    c_spec = P() if reduce == "psum" else P(axis, None)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(), c_spec, P(), P()),
        out_specs=c_spec, check_vma=True))


@functools.lru_cache(maxsize=None)
def _mode2p_spmv_program(mesh: Mesh, axis: str, reduce: str, kind: str,
                         m: int, band_rows: int):
    n = mesh.shape[axis]
    m_full = _round_up(m + band_rows, n * 128)

    def fn(shards, x, y, alpha, beta):
        plan = _unstack(shards.plan)
        local = _local_spmv(kind, plan, x)          # (band_rows,)
        partial_y = jnp.zeros(m_full, local.dtype)
        partial_y = lax.dynamic_update_slice(
            partial_y, local, (shards.row_offsets[0, 0],))
        if reduce == "psum":
            return beta * y + alpha * lax.psum(partial_y, axis)[:m]
        mine = lax.psum_scatter(partial_y, axis, tiled=True)
        return beta * y + alpha * mine

    y_spec = P() if reduce == "psum" else P(axis)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(), y_spec, P(), P()),
        out_specs=y_spec,
        check_vma=True))


def spmm_mode2_planned(shards: RowPlanShards, B, alpha, beta, C, mesh: Mesh,
                       axis: str = DEFAULT_AXIS,
                       reduce: str = "psum") -> jax.Array:
    """Mode 2 (partition sparse A) with per-shard fast plans.

    Same collective contract as `modes.spmm_mode2`; per-shard compute runs
    the fast layouts instead of COO segment-sum."""
    require(shards.kind != "routed", PartitionError,
            "routed shards are SpMV-only (RoutedPlan has no K-wide analog);"
            " build SpMM shards with partition_row_plans(kind=...) in "
            "{'bsr','ell','dia','coo'}")
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {n}")
    require(B.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != B height {B.shape[0]}")
    m = shards.shape[0]
    prog = _mode2p_spmm_program(mesh, axis, reduce, shards.kind, m,
                                shards.band_rows)
    if reduce == "psum":
        return prog(shards, B, C, alpha, beta)
    m_full = _round_up(m + shards.band_rows, n * 128)
    C_p = jnp.pad(C, ((0, m_full - m), (0, 0)))
    out = prog(shards, B, C_p, alpha, beta)
    return out[:m]


def spmv_dist_planned(shards: RowPlanShards, x, alpha, beta, y, mesh: Mesh,
                      axis: str = DEFAULT_AXIS,
                      reduce: str = "psum") -> jax.Array:
    """Distributed SpMV (partition sparse A) with per-shard fast plans."""
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {n}")
    require(x.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != x length {x.shape[0]}")
    m = shards.shape[0]
    prog = _mode2p_spmv_program(mesh, axis, reduce, shards.kind, m,
                                shards.band_rows)
    if reduce == "psum":
        return prog(shards, x, y, alpha, beta)
    m_full = _round_up(m + shards.band_rows, n * 128)
    out = prog(shards, x, jnp.pad(y, (0, m_full - m)), alpha, beta)
    return out[:m]


@functools.lru_cache(maxsize=None)
def _mode2p_nocomm_program(mesh: Mesh, axis: str, kind: str, op: str):
    def fn(shards, operand):
        plan = _unstack(shards.plan)
        if op == "spmm":
            return _local_spmm(kind, plan, operand)
        return _local_spmv(kind, plan, operand)

    out = P(axis, None) if op == "spmm" else P(axis)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(axis), P()), out_specs=out,
        check_vma=True))


def spmm_mode2_planned_nocomm(shards: RowPlanShards, B, mesh: Mesh,
                              axis: str = DEFAULT_AXIS) -> jax.Array:
    """Diagnostic: per-shard compute without the collective (comm/compute
    phase split for drivers; reference prints per-GPU NCCL time,
    spmm.h:258-271).  Values are unplaced partials — timing only."""
    return _mode2p_nocomm_program(mesh, axis, shards.kind, "spmm")(shards, B)


def spmv_dist_planned_nocomm(shards: RowPlanShards, x, mesh: Mesh,
                             axis: str = DEFAULT_AXIS) -> jax.Array:
    """Diagnostic twin of `spmv_dist_planned` without the collective."""
    return _mode2p_nocomm_program(mesh, axis, shards.kind, "spmv")(shards, x)


# ---------------------------------------------------------------------------
# Halo SpMV with per-shard DIA plans
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["plan"],
         meta_fields=["shape", "nnz", "n_shards", "rows_per_shard"])
@dataclasses.dataclass(frozen=True)
class HaloDiaShards:
    """Per-shard DIA plans over the [left | own | right] x window."""

    plan: object  # stacked DiaPlan, local shape (rows_per_shard, 3r)
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    rows_per_shard: int


def partition_halo_dia(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                       config: SBlasConfig = DEFAULT) -> HaloDiaShards:
    """Row blocks whose local matrices are DIA plans in x_ext coordinates
    (column shift r - s*r): the banded halo path runs shift-and-FMA."""
    blocks = partition_row_blocks(A, n_shards, dtype=dtype, config=config)
    r = blocks.rows_per_shard
    require(blocks.halo_left <= r and blocks.halo_right <= r, PartitionError,
            f"halo ({blocks.halo_left}/{blocks.halo_right}) exceeds one "
            f"block ({r})")
    m = A.shape[0]
    # per-shard local CSR in x_ext coords: col_ext = col - (s*r - r)
    subs = []
    for s in range(n_shards):
        r0, r1 = min(s * r, m), min((s + 1) * r, m)
        subs.append(_local_csr(A, r0, r1, r, col_shift=r - s * r,
                               width=3 * r))
    offs = _union_offsets(subs)
    plans = []
    for sub in subs:
        vals, offs_t = dia_arrays(sub, offsets=offs, n_rows=r)
        plans.append(DiaPlan(jnp.asarray(vals, dtype), offs_t,
                             (r, 3 * r), A.nnz))
    return HaloDiaShards(plan=_stack_plans(plans), shape=A.shape, nnz=A.nnz,
                         n_shards=n_shards, rows_per_shard=r)


@functools.lru_cache(maxsize=None)
def _halo_dia_program(mesh: Mesh, axis: str):
    n = mesh.shape[axis]

    def fn(shards, x_blk, y_blk, alpha, beta):
        plan = _unstack(shards.plan)
        from_left = lax.ppermute(x_blk, axis,
                                 perm=[(i, (i + 1) % n) for i in range(n)])
        from_right = lax.ppermute(x_blk, axis,
                                  perm=[(i, (i - 1) % n) for i in range(n)])
        x_ext = jnp.concatenate([from_left, x_blk, from_right])
        z = jnp.zeros(plan.shape[0], plan.vals.dtype)
        return beta * y_blk + alpha * spmv_dia(plan, x_ext, 1.0, 0.0, z)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis)))


def spmv_halo_planned(shards: HaloDiaShards, x, alpha, beta, y, mesh: Mesh,
                      axis: str = DEFAULT_AXIS) -> jax.Array:
    """Halo-exchange SpMV with per-shard DIA kernels (banded multi-chip)."""
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {n}")
    m = shards.shape[0]
    m_pad = shards.rows_per_shard * n

    def padv(v):
        return jnp.pad(v, (0, m_pad - m))

    out = _halo_dia_program(mesh, axis)(shards, padv(x), padv(y),
                                        alpha, beta)
    return out[:m]


@functools.lru_cache(maxsize=None)
def _halo_dia_spmm_program(mesh: Mesh, axis: str):
    n = mesh.shape[axis]

    def fn(shards, B_blk, C_blk, alpha, beta):
        plan = _unstack(shards.plan)
        from_left = lax.ppermute(B_blk, axis,
                                 perm=[(i, (i + 1) % n) for i in range(n)])
        from_right = lax.ppermute(B_blk, axis,
                                  perm=[(i, (i - 1) % n) for i in range(n)])
        B_ext = jnp.concatenate([from_left, B_blk, from_right], axis=0)
        z = jnp.zeros((plan.shape[0], B_blk.shape[1]), plan.vals.dtype)
        return beta * C_blk + alpha * spmm_dia(plan, B_ext, 1.0, 0.0, z)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(axis, None), P(axis, None), P(), P()),
        out_specs=P(axis, None)))


def spmm_halo_planned(shards: HaloDiaShards, B, alpha, beta, C, mesh: Mesh,
                      axis: str = DEFAULT_AXIS) -> jax.Array:
    """Halo-exchange SpMM: B and C row-block-sharded like A's rows; each
    shard pulls only its neighbors' B row blocks over the links — the
    banded SpMM scaling mode (constant comm in n, vs mode 2's full-C
    all-reduce).  Requires square A (B rows follow A's row partition)."""
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {n}")
    require(shards.shape[0] == shards.shape[1], PartitionError,
            "halo SpMM needs square A (B rows follow A's row partition)")
    m = shards.shape[0]
    m_pad = shards.rows_per_shard * n

    def padm(M):
        return jnp.pad(M, ((0, m_pad - m), (0, 0)))

    out = _halo_dia_spmm_program(mesh, axis)(shards, padm(B), padm(C),
                                             alpha, beta)
    return out[:m]
