"""Footprint-compressed x-exchange SpMV (comm-avoiding distributed mode).

The reference's only distributed SpMV moves the FULL result vector
through an all-reduce (spmv.h:115-118) — comm stays ~m bytes/chip while
compute shrinks 1/n, so efficiency collapses by construction.  This mode keeps x AND y row-block-sharded — the steady
state of every solver loop (CG, PageRank) — and moves only the x entries
each shard's columns actually reference:

* **own block** — rows [s*r, (s+1)*r) read x[s*r:(s+1)*r) locally: free.
  Web-graph locality (most links near-diagonal) puts the bulk here.
* **hot set** — the exact columns demanded by >= 2 remote shards
  (web-graph hubs) are broadcast once through ONE small `psum`.  The hot
  buffer is ordered BY OWNER, so each owner's contribution is one
  contiguous compact segment: the extraction engine emits it directly
  and a single dynamic_update_slice at a plan-time offset places it —
  no scatter, no interval slack.  Cost 2*|hot|*(n-1)/n bytes/chip,
  independent of how many shards demand each column.  (A column
  demanded by q>=2 shards costs q packet copies + duplicate staging in
  the alternative — the broadcast always wins at q>=2; q=1 never does.)
* **cold packets** — columns demanded by exactly ONE remote shard go
  point-to-point: each (owner -> demander) column list becomes one
  segment of a single `lax.all_to_all`, padded to the max pair size.
  Bytes/chip = (n-1)*P*itemsize, typically << m/n.

Both the hot contribution and the packet send buffer come out of one
per-shard **extraction** of `x_blk` into `[hot segment | packets]`
order, by one of two engines chosen by modeled cost: a **routed
permutation** (ops/route.py — lane shuffles + transposes, priced per
element of padded route space; q=1 packets plus owner-unique hot
columns make the map a bijection, which is exactly what a Clos network
computes) or a plain **flat XLA gather** (priced per output element).
The prices are `scaling.GATHER_NS` / `scaling.ROUTE_NS`, calibrated per
device kind (scaling_calib.json).

The local compute then runs any of the framework's fast per-shard plans
(routed / wcoo / dia / ell / bsr) over the concatenated
`x_ext = [own | hot | packets]` window — the plan's column ids are
remapped into x_ext coordinates AT PLAN TIME, so the irregular layout
costs nothing at run time (the routed plan relabels columns internally
anyway).  The output stays row-sharded: ZERO output collective.

`xfoot_stats` computes the exchange geometry WITHOUT building plans
(no edge coloring): the real footprint bytes per call, against the
m-byte collective of mode 2.

No reference analog: this subsumes the halo mode (banded matrices
degenerate to adjacent-pair packets with an empty hot set) and is the
framework's answer to the reference's full-C all-reduce bottleneck.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import DEFAULT_AXIS
from .planned import _local_spmv, _unstack, build_stacked_plans, \
    pick_shard_kind


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class XFootStats(NamedTuple):
    """Exchange geometry of one xfoot partition (all plan-time).

    Per-chip byte counts count ring collectives' exposed bytes;
    extraction is priced by the chosen
    engine (`extract_ns` = modeled per-chip nanoseconds per call)."""

    n_shards: int
    hot_total: int        # exact columns in the hot broadcast buffer
    hot_own_max: int      # max columns one owner contributes (padded)
    packet_pad: int       # P: per-(owner,demander) packet slots (padded)
    packet_max: int       # largest real (owner,demander) column list
    remote_unique: int    # max over shards of unique remote cols needed
    send_real: int        # max over owners of real entries it extracts
    extract_mode: str     # "none" | "flat" | "route"
    extract_ns: float     # modeled per-chip extraction time per call
    hot_qmin: int = 2     # demand threshold defining the hot set

    def comm_bytes(self, itemsize: int) -> float:
        n = self.n_shards
        if n <= 1:
            return 0.0
        hot = 2.0 * self.hot_total * (n - 1) / n * itemsize
        a2a = float((n - 1) * self.packet_pad * itemsize)
        return hot + a2a


def _groupby(values: np.ndarray, keys: np.ndarray):
    """(unique_keys, [values per key]); inputs need not be sorted."""
    if len(values) == 0:
        return [], []
    order = np.argsort(keys, kind="stable")
    v, k = values[order], keys[order]
    uk, first = np.unique(k, return_index=True)
    return uk, np.split(v, first[1:])


def _xfoot_analyze(A: CsrMatrix, n_shards: int, hot_qmin: int = 0):
    """Classify every (shard, referenced column) into own / hot / cold
    and lay out the owner-ordered hot buffer + packets.

    `hot_qmin` <= 0 means the default threshold 2.  Raising it LOOKS
    attractive on raw bytes (webbase n=16: q>=4 models 777 -> 516
    KB/chip because low-q hot columns ride existing all_to_all pad
    slack) but is a measured NET LOSS: a q-in-[2,qmin) column then
    appears in q packets, the extraction map stops being a bijection,
    and the routed extraction engine (a Clos network — permutations
    only, no multicast) cannot express it; materializing the duplicate
    copies costs ~2.3 ns each (~10^2 us/call at webbase scale) where
    the psum's network fanout did it for free.  q>=2 with route
    extraction is structurally optimal; the knob stays for small-
    footprint experiments (duplicates force the flat engine)."""
    from ..scaling import GATHER_NS, ROUTE_NS
    from ..ops.route import routable_size
    from ..utils.errors import PlanError, require
    m, n = A.shape
    require(max(m, n, A.nnz) < 2**31, PlanError,
            "xfoot plans are int32-indexed")
    band_rows = _round_up(-(-m // n_shards) or 1, 128)
    r_x = _round_up(-(-n // n_shards) or 1, 128)

    # per-shard unique referenced columns + remote demand count q(c)
    # (int32 throughout: this host pays ~14x for 64-bit random access)
    uniq_cols = []
    q = np.zeros(n, dtype=np.int32)
    for s in range(n_shards):
        r0, r1 = min(s * band_rows, m), min((s + 1) * band_rows, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        cols_s = np.unique(A.col_idx[lo:hi].astype(np.int32))
        uniq_cols.append(cols_s)
        remote = cols_s[(cols_s // r_x) != s]
        q[remote] += 1

    if hot_qmin < 2:
        hot_qmin = 2
    # hot = exact q>=hot_qmin set, owner-grouped (sorted col order groups
    # owners since ownership is by contiguous block)
    hot_cols = np.flatnonzero(q >= hot_qmin).astype(np.int32)
    H_tot = len(hot_cols)
    hot_own = np.zeros(n_shards, dtype=np.int64)   # cols owned per shard
    hot_off = np.zeros(n_shards, dtype=np.int64)   # owner segment start
    if H_tot:
        owners = hot_cols // r_x
        hot_own = np.bincount(owners, minlength=n_shards).astype(np.int64)
        hot_off = np.concatenate([[0], np.cumsum(hot_own)[:-1]])

    def hot_lookup(cols):
        """-1 for non-hot, else position in the hot buffer."""
        pos = np.full(len(cols), -1, dtype=np.int32)
        if H_tot:
            j = np.searchsorted(hot_cols, cols).astype(np.int32)
            jc = np.clip(j, 0, H_tot - 1)
            ok = hot_cols[jc] == cols
            pos[ok] = jc[ok]
        return pos

    # cold packets (q == 1): per (demander s, owner t) sorted column lists
    packets = {}
    pack_max = 0
    remote_unique = 0
    for s in range(n_shards):
        cols_s = uniq_cols[s]
        owner = cols_s // r_x
        remote = cols_s[owner != s]
        remote_unique = max(remote_unique, len(remote))
        cold = remote[hot_lookup(remote) < 0]
        for t, grp in zip(*_groupby(cold, cold // r_x)):
            packets[(s, int(t))] = grp
            pack_max = max(pack_max, len(grp))
    P_pad = _round_up(pack_max, 128) if pack_max else 0

    send_real = 0
    for t in range(n_shards):
        tot = int(hot_own[t]) + sum(
            len(packets[(s, t)]) for s in range(n_shards)
            if (s, t) in packets)
        send_real = max(send_real, tot)

    # extraction engine by modeled cost
    Hmax = _round_up(int(hot_own.max()), 128) if H_tot else 0
    out_slots = Hmax + n_shards * P_pad
    # a forced hot_qmin > 2 sends q-in-[2,qmin) columns to SEVERAL
    # demanders' packets — the extraction map stops being injective and
    # the routed engine (permutations only) cannot express it
    dup = hot_qmin > 2 and bool(((q >= 2) & (q < hot_qmin)).any())
    if out_slots == 0:
        mode, extract_ns, route_space = "none", 0.0, 0
    else:
        route_space = routable_size(max(r_x, out_slots))
        flat_ns = GATHER_NS * out_slots
        route_ns = ROUTE_NS * route_space
        mode, extract_ns = (("flat", flat_ns)
                            if dup or flat_ns <= route_ns
                            else ("route", route_ns))

    stats = XFootStats(
        n_shards=n_shards, hot_total=H_tot, hot_own_max=Hmax,
        packet_pad=P_pad, packet_max=pack_max,
        remote_unique=remote_unique, send_real=send_real,
        extract_mode=mode, extract_ns=extract_ns, hot_qmin=hot_qmin)
    return {
        "band_rows": band_rows, "r_x": r_x, "H_tot": H_tot,
        "hot_own": hot_own, "hot_off": hot_off, "hot_cols": hot_cols,
        "Hmax": Hmax, "packets": packets, "P": P_pad,
        "hot_lookup": hot_lookup, "route_space": route_space,
        "dup": dup, "stats": stats,
    }


def xfoot_stats(A: CsrMatrix, n_shards: int,
                config: SBlasConfig = DEFAULT) -> XFootStats:
    """Exchange geometry only (no plan build / edge coloring): the real
    footprint bytes of the xfoot mode, dtype-independent."""
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    return _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)["stats"]


def _remap_local(A: CsrMatrix, s: int, lay: dict) -> CsrMatrix:
    """Shard s's rows as a (band_rows, w_ext) local CSR with columns
    remapped into x_ext = [own | hot | packets] coordinates."""
    m = A.shape[0]
    band_rows, r_x = lay["band_rows"], lay["r_x"]
    H_tot, Pp = lay["H_tot"], lay["P"]
    w_ext = r_x + H_tot + lay["stats"].n_shards * Pp
    r0, r1 = min(s * band_rows, m), min((s + 1) * band_rows, m)
    lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
    rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                         np.full(band_rows - (r1 - r0), hi - lo,
                                 dtype=A.row_ptr.dtype)])
    cols = A.col_idx[lo:hi].astype(np.int32)
    owner = cols // r_x
    newc = np.empty_like(cols)
    own = owner == s
    newc[own] = cols[own] - s * r_x
    rem = ~own
    if rem.any():
        rc = cols[rem]
        hpos = lay["hot_lookup"](rc)
        nc = np.empty_like(rc)
        hmask = hpos >= 0
        nc[hmask] = r_x + hpos[hmask]
        cold = ~hmask
        if cold.any():
            cc, co = rc[cold], owner[rem][cold]
            pos = np.empty_like(cc)
            for t in np.unique(co):
                sel = co == t
                pos[sel] = int(t) * Pp + np.searchsorted(
                    lay["packets"][(s, int(t))], cc[sel])
            nc[cold] = r_x + H_tot + pos
        newc[rem] = nc
    return CsrMatrix(rp, newc, A.values[lo:hi], (band_rows, w_ext))


def xfoot_worst_local(A: CsrMatrix, n_shards: int,
                      config: SBlasConfig = DEFAULT):
    """The remapped local CSR of the HEAVIEST shard (max nnz) plus the
    shared static routed sizes over all shards.

    Bench uses this to MEASURE the per-shard compute time of the xfoot
    mode on the one real chip (one plan build instead of n): build a
    RoutedPlan with `min_gtiles/min_srows/min_prows` from the returned
    sizes and time it — that is exactly what every shard executes inside
    the shard_map program, so max-shard time + modeled exchange = t_n."""
    from ..ops.rspmv import routed_shard_sizes
    from .planned import shared_routed_sizes
    lay = _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)
    locals_ = [_remap_local(A, s, lay) for s in range(n_shards)]
    sizes = [routed_shard_sizes(sub, config) for sub in locals_]
    worst = int(np.argmax([sub.nnz for sub in locals_]))
    return locals_[worst], shared_routed_sizes(sizes)


@partial(jax.tree_util.register_dataclass,
         data_fields=["plan", "hot_put", "hot_cnt", "send_idx",
                      "xroute_tables"],
         meta_fields=["shape", "nnz", "n_shards", "band_rows", "r_x",
                      "kind", "hot_total", "hot_own_max", "packet_pad",
                      "extract_mode", "xroute_schedule", "xroute_n",
                      "stats"])
@dataclasses.dataclass(frozen=True)
class XFootShards:
    """Stacked per-shard plans + exchange tables (see module docstring).

    hot_put: (n, 1) i32   owner-segment start of this shard's hot
                          contribution inside the hot buffer
    hot_cnt: (n, 1) i32   how many hot columns this shard owns
    send_idx: (n, S) i32  flat extraction: local x indices producing
                          [hot segment (hot_own_max) | packets (n*P)];
                          empty for route mode
    xroute_tables         route extraction: stacked per-shard layer
                          tables computing the same layout
    """

    plan: object
    hot_put: jax.Array
    hot_cnt: jax.Array
    send_idx: jax.Array
    xroute_tables: Tuple
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    band_rows: int
    r_x: int
    kind: str
    hot_total: int
    hot_own_max: int
    packet_pad: int
    extract_mode: str
    xroute_schedule: Tuple
    xroute_n: int
    stats: XFootStats


def partition_xfoot(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                    kind: str = None, extract: str = None,
                    config: SBlasConfig = DEFAULT) -> XFootShards:
    """Equal row-block shards whose local plans read a remapped
    `x_ext = [own | hot | packets]` window (module docstring).

    `extract` forces the extraction engine ("flat" | "route"); default
    picks by modeled cost (stats.extract_mode)."""
    from ..ops.route import build_route, route_tables_device
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    m, n = A.shape
    lay = _xfoot_analyze(A, n_shards, config.xfoot_hot_qmin)
    band_rows, r_x = lay["band_rows"], lay["r_x"]
    H_tot, Hmax, Pp = lay["H_tot"], lay["Hmax"], lay["P"]
    hot_cols, hot_own, hot_off = (lay["hot_cols"], lay["hot_own"],
                                  lay["hot_off"])
    w_ext = r_x + H_tot + n_shards * Pp
    out_slots = Hmax + n_shards * Pp
    mode = extract or lay["stats"].extract_mode
    require(not (mode == "route" and lay["dup"]), PartitionError,
            "route extraction cannot express the duplicated packets a "
            "forced xfoot_hot_qmin > 2 creates (Clos networks are "
            "permutations — no multicast); use extract='flat'")
    if mode != lay["stats"].extract_mode:
        # keep the stats' modeled time consistent with the forced engine
        from ..scaling import GATHER_NS, ROUTE_NS
        forced_ns = (GATHER_NS * out_slots if mode == "flat"
                     else ROUTE_NS * lay["route_space"])
        lay["stats"] = lay["stats"]._replace(extract_mode=mode,
                                             extract_ns=forced_ns)

    # ---- extraction tables: local x -> [hot segment | packets] ----
    # owner t's hot contribution = its owned hot cols in buffer order
    # (hot_cols is sorted, ownership is contiguous -> one compact run)
    # int32 throughout: values are local x indices < r_x < 2^31 (PlanError
    # guard upstream), and this host pays ~14x for 64-bit random access —
    # at large out_slots x n_shards an int64 table doubles the footprint
    send_idx = np.zeros((n_shards, 0), dtype=np.int32)
    xroute_tables = ()
    xroute_schedule = ()
    xroute_n = 0
    if out_slots:
        src_of = np.zeros((n_shards, out_slots), dtype=np.int32)
        used_of = np.zeros((n_shards, out_slots), dtype=bool)
        for t in range(n_shards):
            h = int(hot_own[t])
            if h:
                mine = hot_cols[int(hot_off[t]):int(hot_off[t]) + h]
                src_of[t, :h] = mine - t * r_x
                used_of[t, :h] = True
            for s in range(n_shards):
                grp = lay["packets"].get((s, t))
                if grp is None:
                    continue
                base = Hmax + s * Pp
                src_of[t, base:base + len(grp)] = grp - t * r_x
                used_of[t, base:base + len(grp)] = True
        if mode == "flat":
            send_idx = src_of
        else:
            L = max(r_x, out_slots)
            from ..ops.route import routable_size
            N = routable_size(L)
            progs = []
            for t in range(n_shards):
                perm = np.full(N, -1, dtype=np.int32)
                perm[:out_slots][used_of[t]] = src_of[t][used_of[t]]
                used = np.zeros(N, dtype=bool)
                used[perm[perm >= 0]] = True
                unassigned = perm < 0
                perm[unassigned] = np.flatnonzero(~used).astype(np.int32)
                progs.append(build_route(perm))
            require(len({p.schedule for p in progs}) == 1, PartitionError,
                    "xfoot extraction route schedules diverged despite a "
                    "shared padded size (planner bug)")
            xroute_schedule = progs[0].schedule
            xroute_n = progs[0].n
            per_shard = [route_tables_device(p) for p in progs]
            xroute_tables = tuple(
                jnp.stack([t[i] for t in per_shard])
                for i in range(len(per_shard[0])))

    # ---- remapped local matrices ----
    locals_ = [_remap_local(A, s, lay) for s in range(n_shards)]

    if kind is None:
        kind = pick_shard_kind(A, config)
    stacked, kind = build_stacked_plans(locals_, kind, band_rows, w_ext,
                                        A.nnz, dtype, config)
    return XFootShards(
        plan=stacked,
        hot_put=jnp.asarray(hot_off.reshape(-1, 1), jnp.int32),
        hot_cnt=jnp.asarray(hot_own.reshape(-1, 1), jnp.int32),
        send_idx=jnp.asarray(send_idx, jnp.int32),
        xroute_tables=xroute_tables,
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        band_rows=band_rows, r_x=r_x, kind=kind,
        hot_total=H_tot, hot_own_max=Hmax, packet_pad=Pp,
        extract_mode=mode, xroute_schedule=xroute_schedule,
        xroute_n=xroute_n, stats=lay["stats"])


@functools.lru_cache(maxsize=None)
def _xfoot_program(mesh: Mesh, axis: str, kind: str, hot_total: int,
                   hot_own_max: int, packet_pad: int, extract_mode: str,
                   xroute_schedule: Tuple, xroute_n: int,
                   nocomm: bool = False):
    from ..ops.route import apply_route
    n = mesh.shape[axis]
    out_slots = hot_own_max + n * packet_pad

    def fn(shards, x_blk, y_blk, alpha, beta):
        plan = _unstack(shards.plan)
        parts = [x_blk]
        if out_slots:
            if extract_mode == "flat":
                packed = x_blk[shards.send_idx[0]]
            else:
                rin = jnp.pad(x_blk, (0, xroute_n - x_blk.shape[0]))
                tables = tuple(t[0] for t in shards.xroute_tables)
                packed = apply_route(xroute_schedule, rin,
                                     tables)[:out_slots]
        if hot_total:
            seg = jnp.where(
                lax.iota(jnp.int32, hot_own_max) < shards.hot_cnt[0, 0],
                packed[:hot_own_max], 0)
            buf = jnp.zeros(hot_total + hot_own_max, x_blk.dtype)
            buf = lax.dynamic_update_slice(buf, seg,
                                           (shards.hot_put[0, 0],))
            hot = buf[:hot_total]
            # nocomm diagnostic twin: keep extraction + local compute,
            # drop only the collectives (comm split for the drivers;
            # reference prints per-GPU NCCL time, spmv.h:112-128)
            parts.append(hot if nocomm else lax.psum(hot, axis))
        if packet_pad:
            send = packed[hot_own_max:].reshape(n, packet_pad)
            recv = send if nocomm else lax.all_to_all(
                send, axis, split_axis=0, concat_axis=0)
            parts.append(recv.reshape(-1))
        x_ext = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        local = _local_spmv(kind, plan, x_ext)
        return beta * y_blk + alpha * local

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=True))


def spmv_xfoot(shards: XFootShards, x, alpha, beta, y, mesh: Mesh,
               axis: str = DEFAULT_AXIS) -> jax.Array:
    """y' = beta*y + alpha*A@x with A row-block-partitioned, x/y sharded
    the same way, and only the column footprint exchanged (hot psum +
    packet all_to_all).  Output stays row-sharded: zero result
    collective.  Reference contract preserved: y = beta*y + alpha*A@x for
    any CSR (spmv.h:35-139); the mechanism replaces its full-vector
    all-reduce."""
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards} shards, mesh has {n}")
    require(x.shape[0] == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != x length {x.shape[0]}")
    m = shards.shape[0]
    x_p = jnp.pad(x, (0, shards.r_x * n - x.shape[0]))
    y_p = jnp.pad(y, (0, shards.band_rows * n - y.shape[0]))
    prog = _xfoot_program(mesh, axis, shards.kind, shards.hot_total,
                          shards.hot_own_max, shards.packet_pad,
                          shards.extract_mode, shards.xroute_schedule,
                          shards.xroute_n)
    return prog(shards, x_p, y_p, alpha, beta)[:m]


def spmv_xfoot_nocomm(shards: XFootShards, x, mesh: Mesh,
                      axis: str = DEFAULT_AXIS) -> jax.Array:
    """Diagnostic twin of `spmv_xfoot` with the collectives dropped
    (extraction and local compute kept): exposed exchange cost = full
    run - this.  Values are WRONG wherever remote columns matter —
    timing only (the same contract as the other nocomm twins)."""
    n = mesh.shape[axis]
    require(shards.n_shards == n, PartitionError,
            f"shards built for {shards.n_shards} shards, mesh has {n}")
    m = shards.shape[0]
    x_p = jnp.pad(x, (0, shards.r_x * n - x.shape[0]))
    y_p = jnp.zeros(shards.band_rows * n, x_p.dtype)
    prog = _xfoot_program(mesh, axis, shards.kind, shards.hot_total,
                          shards.hot_own_max, shards.packet_pad,
                          shards.extract_mode, shards.xroute_schedule,
                          shards.xroute_n, nocomm=True)
    return prog(shards, x_p, y_p, 1.0, 0.0)[:m]
