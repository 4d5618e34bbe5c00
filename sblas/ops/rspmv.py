"""Routed SpMV: unstructured SpMV as a gather, a static permutation and
a row-granular reduce.

Built for hardware on which an elementwise gather or scatter is the
bottleneck (the reference delegates irregular SpMV to cuSPARSE,
spmv.h:104-106).  Every stage addresses data in whole tiles or rows:

1. **Slab-bucket gather.**  x is viewed as (n/16384) slabs of (128, 128).
   Nonzeros are grouped per slab and bucketed by sublane
   (`(col % 16384) // 128`), so a (128, 128) tile reads all its x values
   from one slab.  Under XLA the stage is one fused gather whose index is
   rebuilt from the tile's slab id and in-slab lane.

2. **Routed permutation (ops/route.py).**  Contributions move from gather
   order to reduce order through the Clos/Beneš layer program — lane
   shuffles + transposes with plan-time tables (bipartite edge coloring,
   native/route.cpp).

3. **Lane-stack reduce.**  Rows are relabeled by descending degree so
   blocks of 128 consecutive ranks have near-uniform degrees.  Row with
   rank r' owns lane r' % 128 of block r' // 128; its contributions are
   routed to stack vertically in that lane.  The reduce is then one
   *row-granular* sorted `segment_sum` over the (S, 128) stack.  A second,
   m-sized routed permutation un-relabels y.

Planning cost is real (edge coloring over ~nnz edges — seconds for
million-scale matrices): this is an analysis-heavy plan in the cuSPARSE
`*_analysis` / FFTW-plan tradition — build once, run many.
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
from ..io import native
from .route import LANES, apply_route, build_route, routable_size

SLAB = 128 * 128     # x window served by one gather tile


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# numpy integer floor-divide/mod are unvectorized per-element divides —
# over nnz-sized arrays that is seconds of plan-build time, so every
# power-of-two divisor below uses shift/mask.
_SLAB_SHIFT = SLAB.bit_length() - 1   # 14
_LANE_SHIFT = 7                       # LANES == 128


def _pow2_shift(d: int):
    """log2(d) when d is a power of two, else None (caller falls back to
    the generic divide)."""
    return d.bit_length() - 1 if d > 0 and (d & (d - 1)) == 0 else None


def _run_local_pos(keys_sorted: np.ndarray, nnz: int) -> np.ndarray:
    """Position of each element within its run of equal keys (keys sorted).

    Streaming replacement for `arange - searchsorted(keys, keys, "left")`
    (the binary search measured ~2 s per 12M-entry call at stress scale):
    mark run starts with one shifted compare, hold each run's start index
    with a cummax, subtract."""
    idx = np.arange(nnz, dtype=np.int32)
    if nnz == 0:
        return idx
    run_start = np.empty(nnz, dtype=bool)
    run_start[0] = True
    np.not_equal(keys_sorted[1:], keys_sorted[:-1], out=run_start[1:])
    return idx - np.maximum.accumulate(np.where(run_start, idx, 0))


# ---------------------------------------------------------------------------
# Layout math (shared by from_csr and the distributed size probe)
# ---------------------------------------------------------------------------

def _balanced_relabel(n: int, res_cols: np.ndarray):
    """Column permutation pi (n,) balancing residual gather load across
    (slab, bucket) pairs: columns sorted by descending count snake-fill
    the buckets, so every bucket's total lands within one column of the
    mean and tiles_per_slab collapses to ~ceil(mean/128).

    Without this the bucket maxima govern the tile count: on the skewed
    webbase proxy T_g*SLAB was 4.9M slots for 2.43M residual nnz; balanced
    it is ~3.1M, which (with the stack bound) pulls route_n from 6.29M
    down to 4.19M.  Lane index = fill cycle (< 128 by construction since
    buckets hold ceil(n / (n_slabs*128)) <= 128 columns)."""
    counts = np.bincount(res_cols, minlength=n).astype(np.int64)
    n_slabs = max(-(-n // SLAB), 1)
    B = n_slabs * LANES
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    r = np.arange(n, dtype=np.int32)
    cycle, pos = r // B, r % B
    b = np.where(cycle % 2 == 0, pos, B - 1 - pos)
    slot = (b * LANES + cycle).astype(np.int32)
    pi = np.empty(n, dtype=np.int32)
    native.scatter(pi, order, slot)
    return pi, n_slabs


def _gather_layout(cols: np.ndarray, nnz: int, n_slabs_min: int = 0):
    """Slab/bucket gather tiling: returns (gslot (nnz,) i32, tiles_per_slab
    (n_slabs,) i64, n_slabs).  Natural tile count = tiles_per_slab.sum()."""
    slab = cols >> _SLAB_SHIFT
    bucket = (cols >> _LANE_SHIFT) & (LANES - 1)
    key = (slab * LANES + bucket).astype(np.int32)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pos = _run_local_pos(key_s, nnz)
    n_slabs = int(slab.max(initial=0)) + 1 if nnz else 1
    n_slabs = max(n_slabs, n_slabs_min, 1)
    counts = np.bincount(key_s, minlength=n_slabs * LANES)
    tiles_per_slab = np.maximum(
        -(-counts.reshape(n_slabs, LANES).max(axis=1) // LANES), 1)
    tile_base = np.concatenate(
        [[0], np.cumsum(tiles_per_slab)]).astype(np.int32)
    tile_of = tile_base[key_s >> _LANE_SHIFT] + (pos >> _LANE_SHIFT)
    gslot_s = (tile_of * SLAB + (key_s & (LANES - 1)) * LANES
               + (pos & (LANES - 1)))
    gslot = np.empty(nnz, dtype=np.int32)
    native.scatter(gslot, order, gslot_s)
    return gslot, tiles_per_slab, n_slabs


def _stack_layout(A: CsrMatrix, cap: int = 0, min_extras: int = 0):
    """Degree-sorted lane-stack layout with capped heavy-row overflow.

    A row's first min(deg, cap) entries stack at its rank position (the
    PRIMARY region — depth per 128-lane block is now bounded by the cap
    instead of the head row's full degree); the remaining entries of
    heavy rows fill size-sorted APPENDIX slots after the primary region.
    Without the cap (cap < 1) a power-law head row sets its whole
    block's depth — measured 2.6x stack fill on a webbase shard, and
    crossing a routable-size cliff doubled the route (1.05M slots for
    202k nnz).

    The appendix partials merge with ONE tiny scatter-add (`merge_ids`
    lists each appendix slot's target rank; appendix slots number
    ~sum(deg)/cap over heavy rows only — hundreds, not m, instead of a
    full rank-space segment-sum).

    Returns (rank (m,) i32, off64 (n_blocks+1,) i64, depth (n_blocks,)
    i32, n_blocks, srank_of_entry-builder, merge_ids (n_extra,) i32,
    n_extra, merged flag); slot space = [primary m_pad | appendix
    n_extra]."""
    m = A.shape[0]
    deg = A.row_nnz.astype(np.int64)
    rank_order = np.argsort(-deg, kind="stable").astype(np.int32)
    rank = np.empty(m, dtype=np.int32)
    native.scatter(rank, rank_order, np.arange(m, dtype=np.int32))
    m_pad = _round_up(max(m, 1), LANES)

    cap = int(cap) if cap and cap >= 1 else 0
    cap_sh = _pow2_shift(cap) if cap else None
    if cap:
        k_r = np.maximum((deg + cap - 1) >> cap_sh if cap_sh is not None
                         else -(-deg // cap), 1)
    else:
        k_r = np.ones(m, dtype=np.int64)
    ex_r = k_r - 1                      # appendix slots per row
    E = int(ex_r.sum())
    E_eff = max(E, int(min_extras))
    n_extra = _round_up(E_eff, LANES) if E_eff else 0
    merged = n_extra > 0

    # primary depths: rank blocks are degree-sorted, so block depth =
    # first rank's capped degree
    pmin = np.minimum(deg, cap) if cap else deg
    p_pad = np.zeros(m_pad, dtype=np.int64)
    p_pad[:m] = pmin[rank_order]
    depth_p = np.maximum(
        p_pad.reshape(m_pad // LANES, LANES).max(axis=1), 1)

    # appendix slots: chunks 1..k-1 of each heavy row, size-sorted
    ex_row = np.repeat(np.arange(m, dtype=np.int32), ex_r)
    ex_base = np.concatenate([[0], np.cumsum(ex_r)[:-1]]).astype(np.int64)
    sub = (np.arange(E, dtype=np.int64) - ex_base[ex_row]) + 1
    ex_size = np.minimum(deg[ex_row] - sub * cap, cap) if E else \
        np.zeros(0, dtype=np.int64)
    order = np.argsort(-ex_size, kind="stable").astype(np.int64)
    apos_of_extra = np.empty(E, dtype=np.int64)
    apos_of_extra[order] = np.arange(E, dtype=np.int64)
    a_pad = np.zeros(n_extra, dtype=np.int64)
    a_pad[:E] = ex_size[order]
    depth_a = np.maximum(
        a_pad.reshape(-1, LANES).max(axis=1), 1) if n_extra else \
        np.zeros(0, dtype=np.int64)

    depth = np.concatenate([depth_p, depth_a]).astype(np.int32)
    n_blocks = m_pad // LANES + n_extra // LANES
    off64 = np.concatenate([[0], np.cumsum(depth, dtype=np.int64)])

    # merge targets: appendix slot -> its row's rank (pads add zero to
    # rank 0, harmless)
    merge_ids = np.zeros(n_extra, dtype=np.int32)
    if E:
        merge_ids[apos_of_extra] = rank[ex_row]

    def srank_of_entry(rows, j_in_row):
        """(srank, within-slot position) for each nnz."""
        if not cap:
            return rank[rows], j_in_row
        sub_e = (j_in_row >> cap_sh if cap_sh is not None
                 else j_in_row // cap)
        j_loc = (j_in_row & (cap - 1) if cap_sh is not None
                 else j_in_row % cap)
        primary = sub_e == 0
        srank = np.where(
            primary, rank[rows],
            m_pad + apos_of_extra[np.where(
                primary, 0, ex_base[rows] + sub_e - 1)]
            if E else 0)
        return srank.astype(np.int32), j_loc

    return (rank, off64, depth, n_blocks, srank_of_entry, merge_ids,
            n_extra, merged)


def _peel_split(cols: np.ndarray, n: int, nnz: int, threshold: int):
    """Boolean mask of entries whose column has >= threshold nonzeros
    (the hub-peel set); all-False when peeling is disabled."""
    if threshold < 1 or nnz == 0:
        return np.zeros(nnz, dtype=bool)
    cnt = np.bincount(cols, minlength=n)
    return cnt[cols] >= threshold


def _peel_layout(pcols: np.ndarray, pvals_in: np.ndarray):
    """Lay peeled entries out as whole 128-lane rows per hub column.

    Entry j of hub c lands at row base[c] + j//128, lane j%128; every row
    carries ONE column id, so the device gathers x once per ROW (128x
    fewer addressed elements than slot-granular gather) and broadcasts.
    Returns (pslot (k,) i64 within-peel slots ordered like pcols sorted,
    order (k,), prow_col (R_p,) i32, pvals (R_p*128,) values, R_p)."""
    # int32 throughout (64-bit random access on the host is far slower);
    # R_p is bounded BEFORE any int32 slot math so a near-2^31
    # nnz peel raises the typed error instead of silently wrapping
    # (ADVICE r2 #2)
    from ..utils.errors import PlanError, require
    order = np.argsort(pcols, kind="stable").astype(np.int32)
    pc_s = pcols[order]
    k = len(pc_s)
    j_in_col = _run_local_pos(pc_s, k)
    uniq, first = np.unique(pc_s, return_index=True)
    cnt_p = np.diff(np.append(first, k))
    rows_per_col = (-(-cnt_p // LANES)).astype(np.int64)
    row_base64 = np.concatenate([[0], np.cumsum(rows_per_col)])
    require(int(row_base64[-1]) * LANES < 2**31, PlanError,
            f"peeled hub rows overflow int32 slots "
            f"(R_p={int(row_base64[-1])}); the matrix is too large/ragged "
            f"for a single routed plan")
    row_base = row_base64.astype(np.int32)
    col_group = np.repeat(np.arange(len(uniq), dtype=np.int32),
                          cnt_p)
    prow = row_base[col_group] + (j_in_col >> _LANE_SHIFT)
    pslot = prow * LANES + (j_in_col & (LANES - 1))
    R_p = int(row_base[-1])
    prow_col = np.repeat(uniq.astype(np.int32), rows_per_col)
    pvals = np.zeros(R_p * LANES, dtype=pvals_in.dtype)
    native.scatter(pvals, pslot, pvals_in[order])
    return pslot, order, prow_col, pvals, R_p


def routed_shard_sizes(A: CsrMatrix, config: SBlasConfig = DEFAULT):
    """Natural (n_gtiles, n_srows, n_prows, n_sranks) a RoutedPlan over A
    would use — the cheap prefix of the plan build (no edge coloring).
    The distributed layer probes every shard with this, takes
    element-wise maxima, and passes them back as from_csr(min_gtiles=...,
    min_srows=..., min_prows=..., min_sranks=...) so all shard plans
    share one static shape."""
    coo = A.to_coo()
    cols = coo.col_idx.astype(np.int32)
    peeled = _peel_split(cols, A.shape[1], A.nnz,
                         config.routed_peel_threshold)
    res = cols[~peeled]
    if len(res) and config.routed_relabel:
        pi, n_slabs_x = _balanced_relabel(A.shape[1], res)
        res = pi[res]
    else:
        n_slabs_x = 1
    _, tiles_per_slab, _ = _gather_layout(res, len(res),
                                          n_slabs_min=n_slabs_x)
    _, off64, _, _, _, _, n_extra, _ = _stack_layout(
        A, cap=config.routed_stack_cap)
    pc = cols[peeled]
    if len(pc):
        _, cnts = np.unique(pc, return_counts=True)
        n_prows = int((-(-cnts // LANES)).sum())
    else:
        n_prows = 0
    return (int(tiles_per_slab.sum()), int(off64[-1]), n_prows,
            int(n_extra))


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["gslab", "gidx", "gvals", "pvals", "prow_col",
                      "tables", "brow_ids", "merge_ids", "unrank_tables",
                      "xroute_tables"],
         meta_fields=["schedule", "unrank_schedule", "xroute_schedule",
                      "shape", "nnz", "n_gtiles", "n_srows", "n_prows",
                      "n_blocks", "n_rank_pad", "merged", "route_n",
                      "unrank_n", "xroute_n", "transport"])
@dataclasses.dataclass(frozen=True)
class RoutedPlan:
    """Plan for the three-stage routed SpMV (see module docstring).

    gslab: (T_g,) i32        x-slab id per gather tile
    gidx:  (T_g,128,128) i32 in-slab lane per slot (pads 0)
    gvals: (T_g,128,128)     values per slot (pads 0)
    pvals: (R_p,128)         peeled hub-column values (pads 0)
    prow_col: (R_p,) i32     the single x column each peeled row reads
    tables / schedule        route layers: gather order -> lane stack
    brow_ids: (S,) i32       block id per stack sublane row (sorted)
    merge_ids: (n_extra,) i32  appendix slot -> target row rank (heavy-row
                             overflow merge, one tiny scatter-add;
                             absent when `merged` is False)
    unrank_tables / unrank_schedule  route layers: rank order -> row order

    Hub columns (in-degree >= config.routed_peel_threshold) are *peeled*
    out of the slab-bucket gather: their entries fill whole 128-lane rows
    that each broadcast one x element, so the contribution costs one
    row-granular gather instead of inflating the per-bucket tile count
    (web-graph in-degree skew otherwise blows the gather fill up ~16x).
    The route source space is [gather slots | peeled slots]."""

    gslab: jax.Array
    gidx: jax.Array
    gvals: jax.Array
    pvals: jax.Array
    prow_col: jax.Array
    tables: Tuple
    brow_ids: jax.Array
    merge_ids: jax.Array
    unrank_tables: Tuple
    xroute_tables: Tuple
    schedule: Tuple
    unrank_schedule: Tuple
    xroute_schedule: Tuple
    shape: Tuple[int, int]
    nnz: int
    n_gtiles: int
    n_srows: int
    n_prows: int
    n_blocks: int
    n_rank_pad: int
    merged: bool
    route_n: int
    unrank_n: int
    xroute_n: int  # 0 = no balanced relabel (no residual entries)
    # main-route element precision: "f32" (value dtype) or "bf16"
    # (opt-in reduced-precision transport, config.routed_transport)
    transport: str = "f32"

    @property
    def gather_fill(self) -> float:
        return ((self.n_gtiles * SLAB + self.n_prows * LANES)
                / max(self.nnz, 1))

    @property
    def stack_fill(self) -> float:
        return self.n_srows * LANES / max(self.nnz, 1)

    def with_transport(self, transport: str) -> "RoutedPlan":
        """Switch the route-transport precision of an existing plan
        (execution-only knob, but the MAIN route's index tables change
        width with it: int16 under bf16, int32 under f32 — the halved
        index stream is part of the HBM saving).
        Used to re-aim cached plans without a rebuild."""
        from ..utils.errors import PlanError, require
        require(transport in ("f32", "bf16"), PlanError,
                f"routed_transport must be 'f32' or 'bf16', "
                f"got {transport!r}")
        if transport == self.transport:
            return self
        require(transport == "f32"
                or jnp.dtype(self.gvals.dtype) == jnp.float32, PlanError,
                "bf16 route transport is only valid with float32 values")
        idx = jnp.int16 if transport == "bf16" else jnp.int32
        return dataclasses.replace(
            self, transport=transport,
            tables=tuple(t.astype(idx) for t in self.tables))

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=jnp.float32,
                 config: SBlasConfig = DEFAULT, *, min_gtiles: int = 0,
                 min_srows: int = 0, min_prows: int = 0,
                 min_sranks: int = 0) -> "RoutedPlan":
        """`min_gtiles` / `min_srows` / `min_prows` / `min_sranks` pad the
        gather-tile count, lane-stack depth, peeled-row count and stack
        slot count up to shared static sizes — the distributed layer uses
        them so per-shard routed plans stack into one shard_map program
        (pad tiles hold val=0 and contribute nothing; the route program's
        layer structure depends only on the padded element count, so
        equal sizes give equal schedules across shards)."""
        from ..utils.errors import PlanError, require
        m, n = A.shape
        coo = A.to_coo()  # CSR order (rows ascending)
        nnz = A.nnz
        require(max(m, n, nnz) < 2**31, PlanError,
                "routed plans are int32-indexed")
        # int32 (and value-dtype-matched float) throughout: the host pays
        # a large penalty for 64-bit random access (14x on scatters)
        rows = coo.row_idx.astype(np.int32)
        cols = coo.col_idx.astype(np.int32)
        np_val = np.dtype(jnp.dtype(dtype).name)
        vals_np = coo.values.astype(np_val)

        transport = str(getattr(config, "routed_transport", "f32"))
        require(transport in ("f32", "bf16"), PlanError,
                f"routed_transport must be 'f32' or 'bf16', "
                f"got {transport!r}")
        require(transport == "f32" or np_val == np.float32, PlanError,
                "bf16 route transport is only valid with float32 values "
                "(f64 would lose 45 mantissa bits; bf16 values already "
                "route at width)")

        # ---- hub peel: high-in-degree columns bypass the slab buckets ----
        peeled = _peel_split(cols, n, nnz, config.routed_peel_threshold)
        res_idx = np.flatnonzero(~peeled)
        pe_idx = np.flatnonzero(peeled)
        res_cols = cols[res_idx]

        # ---- balanced relabel + x route (skipped when nothing residual
        # or when config.routed_relabel is off — with peeling on, the
        # residual bucket imbalance is bounded by the peel threshold and
        # the per-call x-route costs ~19 us at shard scale;
        # min_gtiles > 0 means distributed stacking, where every shard
        # must carry the same xroute schedule — an empty shard builds the
        # identity relabel) ----
        if (len(res_idx) or min_gtiles) and config.routed_relabel:
            if len(res_idx):
                pi, n_slabs_x = _balanced_relabel(n, res_cols)
            else:
                n_slabs_x = max(-(-n // SLAB), 1)
                pi = np.arange(n, dtype=np.int32)
            p_cols = pi[res_cols]
            N_x = routable_size(n_slabs_x * SLAB)
            perm_x = np.full(N_x, -1, dtype=np.int32)
            native.scatter(perm_x, pi, np.arange(n, dtype=np.int32))
            perm_x[perm_x < 0] = np.arange(n, N_x, dtype=np.int32)
            progx = build_route(perm_x)
        else:
            p_cols, n_slabs_x, N_x, progx = res_cols, 1, 0, None

        # ---- gather tiling: per (slab, bucket) runs of <= 128 lanes ----
        gslot_res, tiles_per_slab, n_slabs = _gather_layout(
            p_cols, len(res_idx), n_slabs_min=n_slabs_x)
        T_g = max(int(tiles_per_slab.sum()), int(min_gtiles))

        gidx = np.zeros(T_g * SLAB, dtype=np.int32)
        gvals = np.zeros(T_g * SLAB, dtype=np_val)
        native.scatter(gidx, gslot_res,
                       (p_cols & (LANES - 1)).astype(np.int32))
        native.scatter(gvals, gslot_res, vals_np[res_idx])
        gslab_arr = np.repeat(
            np.arange(n_slabs, dtype=np.int32), tiles_per_slab)
        gslab_arr = np.pad(gslab_arr, (0, T_g - len(gslab_arr)))

        # ---- peeled layout: whole 128-lane rows per hub column ----
        pslot, p_order, prow_col, pvals_flat, R_p = _peel_layout(
            cols[pe_idx], vals_np[pe_idx])
        R_p = max(R_p, int(min_prows))
        prow_col = np.pad(prow_col, (0, R_p - len(prow_col)))
        pvals_flat = np.pad(pvals_flat, (0, R_p * LANES - len(pvals_flat)))
        require(T_g * SLAB + R_p * LANES < 2**31, PlanError,
                f"gather tiling overflows int32 slots (T_g={T_g}, "
                f"R_p={R_p}); the matrix is too large/ragged for a single "
                f"routed plan")

        # global source slots: [gather space | peeled space]
        gslot = np.empty(nnz, dtype=np.int32)
        gslot[res_idx] = gslot_res
        native.scatter(gslot, pe_idx[p_order],
                       (T_g * SLAB + pslot).astype(np.int32))

        # ---- reduce layout: capped lane stack with heavy-row overflow
        # appendix (see _stack_layout) ----
        (rank, off64, depth, n_blocks, srank_of_entry, merge_ids,
         n_extra, merged) = _stack_layout(A, cap=config.routed_stack_cap,
                                          min_extras=min_sranks)
        S = max(int(off64[-1]), int(min_srows))
        require(S * LANES < 2**31, PlanError,
                f"lane stack overflows int32 slots (S={S}); one row's nnz "
                f"is too extreme for a single routed plan")
        off = off64.astype(np.int32)
        m_padr = _round_up(max(m, 1), LANES)
        # nnz slot: j-th entry of row r (CSR position - row start) stacks
        # at sublane off[block] + within, lane srank % 128
        j_in_row = np.arange(nnz, dtype=np.int32) - np.repeat(
            A.row_ptr[:-1].astype(np.int32), A.row_nnz)
        srank, within = srank_of_entry(rows, j_in_row)
        rslot = ((off[srank >> _LANE_SHIFT] + within) * LANES
                 + (srank & (LANES - 1)))
        brow_ids = np.concatenate([
            np.repeat(np.arange(n_blocks, dtype=np.int32), depth),
            # stack pad rows attach to the last block (stays sorted; the
            # routed pad slots carry zeros, so they add nothing)
            np.full(S - int(off64[-1]), n_blocks - 1, dtype=np.int32)])

        # ---- route 1: [gather | peeled] order -> lane-stack order ----
        N = routable_size(max(T_g * SLAB + R_p * LANES, S * LANES))
        perm = np.full(N, -1, dtype=np.int32)
        native.scatter(perm, rslot, gslot)
        src_used = np.zeros(N, dtype=bool)
        native.scatter(src_used, gslot, True)
        perm[perm < 0] = np.flatnonzero(~src_used).astype(np.int32)
        prog = build_route(perm)

        # ---- route 2: rank order -> row order (un-relabel y) ----
        N2 = routable_size(m_padr)
        assert N2 >= m_padr
        perm2 = np.concatenate([rank, np.arange(m, N2, dtype=np.int32)])
        prog2 = build_route(perm2)

        def _tables(pr, idx_dtype=np.int32):
            # bf16 transport stores the MAIN route's tables in int16:
            # lane indices are < 128 and mix ranks < the layer arity
            # (both exact in int16), and the halved index stream is half
            # of the bf16 transport's HBM saving
            return tuple(jnp.asarray(op[1].astype(idx_dtype, copy=False))
                         for op in pr.ops if op[0] in ("gather", "mix"))

        main_idx = np.int16 if transport == "bf16" else np.int32

        return cls(
            gslab=jnp.asarray(gslab_arr),
            gidx=jnp.asarray(gidx.reshape(T_g, LANES, LANES)),
            gvals=jnp.asarray(gvals.reshape(T_g, LANES, LANES), dtype),
            pvals=jnp.asarray(pvals_flat.reshape(R_p, LANES), dtype),
            prow_col=jnp.asarray(prow_col, jnp.int32),
            tables=_tables(prog, main_idx),
            brow_ids=jnp.asarray(brow_ids),
            merge_ids=jnp.asarray(merge_ids),
            unrank_tables=_tables(prog2),
            xroute_tables=_tables(progx) if progx is not None else (),
            schedule=prog.schedule,
            unrank_schedule=prog2.schedule,
            xroute_schedule=(progx.schedule if progx is not None else ()),
            xroute_n=N_x,
            shape=A.shape, nnz=nnz, n_gtiles=T_g, n_srows=S, n_prows=R_p,
            n_blocks=n_blocks, n_rank_pad=m_padr, merged=merged,
            route_n=prog.n, unrank_n=prog2.n, transport=transport)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def _gathered_contrib(plan: RoutedPlan, x: jax.Array) -> jax.Array:
    """(T_g*SLAB,) contributions vals[i]*x[col[i]] in gather order."""
    n = plan.shape[1]
    n_slabs = _round_up(n, SLAB) // SLAB
    if plan.xroute_n:
        # balanced relabel: x permuted into slot order (one small route —
        # ~n elements — buys near-uniform bucket loads and a much smaller
        # main route; see _balanced_relabel)
        xr = apply_route(plan.xroute_schedule,
                         jnp.pad(x, (0, plan.xroute_n - n)),
                         plan.xroute_tables)
        x_flat = xr[: n_slabs * SLAB]
    else:
        x_flat = jnp.pad(x, (0, n_slabs * SLAB - n))
    # slot (t, r, c) reads x_flat[gslab[t]*SLAB + r*128 + gidx[t, r, c]];
    # XLA fuses the index arithmetic into the gather
    sublane = jax.lax.broadcasted_iota(jnp.int32, plan.gidx.shape, 1)
    col = ((plan.gslab[:, None, None] << _SLAB_SHIFT)
           + (sublane << _LANE_SHIFT) + plan.gidx)
    picked = jnp.take(x_flat, col, axis=0)
    out_dtype = jnp.bfloat16 if plan.transport == "bf16" else x.dtype
    # products form at the value dtype; only the stored contribution
    # narrows under bf16 transport
    return (plan.gvals.astype(x.dtype) * picked).astype(out_dtype).reshape(-1)


@jax.jit
def spmv_routed(plan: RoutedPlan, x: jax.Array, alpha, beta,
                y: jax.Array) -> jax.Array:
    m = plan.shape[0]
    contrib = _gathered_contrib(plan, x)
    if plan.n_prows:
        # peeled hub columns: one x element per 128-lane row, broadcast
        # across the row; products form at the value dtype and only the
        # STORE narrows under bf16 transport (casting x itself would
        # square the rounding)
        xp = jnp.take(x, plan.prow_col, axis=0)
        pc = (plan.pvals.astype(x.dtype)
              * xp[:, None]).astype(contrib.dtype)
        contrib = jnp.concatenate([contrib, pc.reshape(-1)])
    contrib = jnp.pad(contrib, (0, plan.route_n - contrib.shape[0]))
    routed = apply_route(plan.schedule, contrib, plan.tables)
    stack = routed[: plan.n_srows * LANES].reshape(
        plan.n_srows, LANES).astype(x.dtype)
    blocks = jax.ops.segment_sum(stack, plan.brow_ids,
                                 num_segments=plan.n_blocks,
                                 indices_are_sorted=True)
    y_srank = blocks.reshape(-1)  # (m_pad + n_extra,): primary | appendix
    y_rank = y_srank[: plan.n_rank_pad]
    if plan.merged:
        # heavy-row overflow merge: add the few appendix partials into
        # their rank positions (scatter cost ~ #appendix slots, not m)
        y_rank = y_rank.at[plan.merge_ids].add(
            y_srank[plan.n_rank_pad:])
    y_rank = jnp.pad(y_rank, (0, plan.unrank_n - y_rank.shape[0]))
    ax = apply_route(plan.unrank_schedule, y_rank, plan.unrank_tables)[:m]
    return beta * y + alpha * ax
