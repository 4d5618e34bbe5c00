"""Multi-device UM ops: host-DRAM-resident sparse A under the v1/v2
distribution strategies.

The reference's UM ops ARE its multi-GPU drivers — `sblas_spmm_csr_v2` /
`sblas_spmv_csr_v1` over managed memory with NCCL (spmm_um.h:163-284,
spmv_um.h:35-139): A lives in managed (host-pageable) memory, each GPU
computes its nnz-segment, and an all-reduce combines partial C.  The
equivalent here:

* A is row-granular nnz-balance partitioned into `n_shards`; each shard is
  band-partitioned to an HBM budget and pinned in host DRAM
  (`host_resident_shards`, composing `partition`-style boundaries with the
  band machinery of `memory.host`).
* `spmv_um_dist` / `spmm_um_dist` stream band b of every shard to its
  device (one sharded `device_put`), run the per-shard fast kernel under
  `shard_map`, accumulate the partial at the shard's global row offset,
  and `psum` once per dispatch — the reference's full-C all-reduce
  semantics (spmm.h:260-262) with compiled collectives.
* `tuning=True` prefetches every band to HBM and runs the WHOLE band loop
  as one `lax.scan` inside a single shard_map program: one dispatch, one
  psum — the analog of `applyGpuTuning` before compute
  (spmm_um.h:185-187).
* `spmm_um_mode1` is the v1 strategy (A replicated, B/C column-sharded,
  zero collectives, spmm.h:83-161) with A streamed band-by-band from host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops.spmm import _match_vma
from ..parallel.mesh import DEFAULT_AXIS
from ..parallel.planned import _row_boundaries
from ..utils.errors import PartitionError, ShapeError, require
from .host import (_INFLIGHT, _UNROLL_MAX_BANDS, _band_matmul,
                   _band_matvec, _choose_band_kind, _host_sharding,
                   _stream_chunk, build_band_plan, probe_band_dims)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HostResidentShards:
    """Per-(shard, band) plans: `bands[b]` is one plan pytree whose leaves
    carry a leading (n_shards,) axis, pinned in host DRAM; `offsets[b, s]`
    is the global first row of shard s's band b."""

    bands: List
    offsets: np.ndarray  # (n_bands, n_shards) int32
    band_rows: int
    n_shards: int
    shape: Tuple[int, int]
    nnz: int
    kind: str
    _device: Optional[tuple] = None  # tuned-mode (stacked, offs) on device

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    @property
    def tuned(self) -> bool:
        return self._device is not None

    # --- residency control (reference matrix_um.h:529-614) ---
    def apply_gpu_tuning(self, mesh: Mesh, axis: str = DEFAULT_AXIS) -> None:
        """Prefetch every band to HBM, concatenated for the one-dispatch
        scan (band leaves already carry a leading (1, n_shards, ...) axis
        pair, so this is a concatenate along the bands axis)."""
        if self._device is not None:
            return
        spec = NamedSharding(mesh, P(None, axis), memory_kind="device")
        dev = [jax.device_put(b, spec) for b in self.bands]
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *dev)
        offs = jax.device_put(
            jnp.asarray(self.offsets[:, :, None], jnp.int32),
            NamedSharding(mesh, P(None, axis, None)))
        self._device = (stacked, offs)
        jax.block_until_ready(self._device)

    def remove_gpu_tuning(self) -> None:
        self._device = None

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()


def host_resident_shards(A: CsrMatrix, n_shards: int, dtype=jnp.float32,
                         hbm_budget_bytes: int = 256 << 20,
                         config: SBlasConfig = DEFAULT,
                         kind: str = None) -> HostResidentShards:
    """nnz-balanced row-granular shards, each band-partitioned to the
    per-device HBM budget and pinned in host DRAM.  All (shard, band)
    plans share ONE static shape so a single compiled program serves the
    whole grid."""
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    m, n = A.shape
    bounds = _row_boundaries(A, n_shards)
    shard_rows = _round_up(int(np.max(bounds[1:] - bounds[:-1])) or 1, 128)
    kind = kind or _choose_band_kind(A, config)

    itemsize = jnp.dtype(dtype).itemsize
    nnz_per_row = A.nnz / max(m, 1)
    budget = hbm_budget_bytes / _INFLIGHT
    if kind == "bsr":
        from ..ops.bsr import bell_stats
        R, _ = config.bsr_block
        st = bell_stats(A, config.bsr_block)
        bytes_per_brow = st["slots"] * R * 128 * (itemsize + 4 / (R * 128))
        band_rows = max(int(budget // max(bytes_per_brow, 1)), 1) * R
    elif kind == "ell":
        L = max(int(A.row_nnz.max()), 1)
        band_rows = max(int(budget // max(L * (itemsize + 4), 1)), 8)
        band_rows = (band_rows // 8) * 8
    else:
        slot_bytes = (itemsize + 12) if kind == "wcoo" else (itemsize + 8)
        bytes_per_row = max(nnz_per_row, 0.1) * slot_bytes * 1.4
        band_rows = max(int(budget // max(bytes_per_row, 1)), 128)
        band_rows = (band_rows // 128) * 128
    band_rows = min(_round_up(band_rows, 128), shard_rows)
    n_bands = -(-shard_rows // band_rows)

    # local CSRs for every (shard, band) cell, all (band_rows, n)
    subs = []     # [band][shard]
    offsets = np.zeros((n_bands, n_shards), dtype=np.int32)
    for b in range(n_bands):
        row = []
        for s in range(n_shards):
            g0 = int(bounds[s]) + b * band_rows
            g1 = min(g0 + band_rows, int(bounds[s + 1]))
            g0c = min(g0, g1)
            lo, hi = int(A.row_ptr[g0c]), int(A.row_ptr[g1])
            rp = np.concatenate([A.row_ptr[g0c:g1 + 1] - lo,
                                 np.full(band_rows - (g1 - g0c), hi - lo,
                                         dtype=A.row_ptr.dtype)])
            row.append(CsrMatrix(rp, A.col_idx[lo:hi], A.values[lo:hi],
                                 (band_rows, n)))
            offsets[b, s] = min(g0, max(m - 1, 0))
        subs.append(row)

    flat = [sub for row in subs for sub in row]
    kind, dim = probe_band_dims(flat, kind, A.nnz, config)

    host = _host_sharding()
    bands = []
    for b in range(n_bands):
        plans = [build_band_plan(sub, kind, dim, band_rows, n, A.nnz,
                                 dtype, config, put=lambda a: a)
                 for sub in subs[b]]
        # leaves get a leading (1, n_shards, ...) axis pair in numpy so
        # streaming needs NO host-array ops — one sharded device_put per
        # band straight from pinned host
        stacked_np = jax.tree_util.tree_map(
            lambda *xs: np.stack(xs)[None], *plans)
        bands.append(jax.tree_util.tree_map(
            lambda a: jax.device_put(a, host), stacked_np))
    return HostResidentShards(bands=bands, offsets=offsets,
                              band_rows=band_rows, n_shards=n_shards,
                              shape=A.shape, nnz=A.nnz, kind=kind)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _um_dist_spmv_program(mesh: Mesh, axis: str, kind: str, m: int,
                          band_rows: int):
    nd = mesh.shape[axis]
    m_full = _round_up(m + band_rows, nd * 128)

    def fn(stacked, offs, x, y, alpha, beta):
        # per-device leaves: (n_bands, 1, ...); offs (n_bands, 1, 1) — OR,
        # for a streaming chunk, `stacked` is a TUPLE of per-band pytrees
        # with leaves (1, 1, ...) so `_stream_chunk()` bands share one
        # dispatch (and one psum).  UNROLLED over bands up to the cap:
        # the unrolled program is linear in band count — above the cap
        # the scan keeps program size O(1)
        chunked = isinstance(stacked, tuple)
        n_bands = (len(stacked) if chunked
                   else jax.tree_util.tree_leaves(stacked)[0].shape[0])
        partial = _match_vma(jnp.zeros(m_full, x.dtype),
                             *jax.tree_util.tree_leaves(stacked))
        if not chunked and n_bands > _UNROLL_MAX_BANDS:
            def step(part, band):
                plans, off = band
                plan = jax.tree_util.tree_map(lambda a: a[0], plans)
                local = _band_matvec(kind, plan, x).astype(part.dtype)
                win = lax.dynamic_slice(part, (off,), (band_rows,))
                return lax.dynamic_update_slice(part, win + local,
                                                (off,)), None

            partial, _ = lax.scan(step, partial, (stacked, offs[:, 0, 0]))
        else:
            for b in range(n_bands):
                plan = jax.tree_util.tree_map(
                    lambda a: a[0, 0] if chunked else a[b, 0],
                    stacked[b] if chunked else stacked)
                local = _band_matvec(kind, plan, x).astype(partial.dtype)
                off = offs[b, 0, 0]
                win = lax.dynamic_slice(partial, (off,), (band_rows,))
                partial = lax.dynamic_update_slice(partial, win + local,
                                                   (off,))
        return beta * y + alpha * lax.psum(partial, axis)[:m]

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(), P(), P(), P()),
        out_specs=P(), check_vma=True))


@functools.lru_cache(maxsize=None)
def _um_dist_spmm_program(mesh: Mesh, axis: str, kind: str, m: int,
                          band_rows: int):
    nd = mesh.shape[axis]
    m_full = _round_up(m + band_rows, nd * 128)

    def fn(stacked, offs, B, C, alpha, beta):
        # unrolled over bands with the same scan fallback and tuple-chunk
        # form — see the SpMV program
        chunked = isinstance(stacked, tuple)
        n_bands = (len(stacked) if chunked
                   else jax.tree_util.tree_leaves(stacked)[0].shape[0])
        partial = _match_vma(jnp.zeros((m_full, B.shape[1]), B.dtype),
                             *jax.tree_util.tree_leaves(stacked))
        if not chunked and n_bands > _UNROLL_MAX_BANDS:
            def step(part, band):
                plans, off = band
                plan = jax.tree_util.tree_map(lambda a: a[0], plans)
                local = _band_matmul(kind, plan, B).astype(part.dtype)
                z = jnp.zeros((), off.dtype)
                win = lax.dynamic_slice(part, (off, z),
                                        (band_rows, part.shape[1]))
                return lax.dynamic_update_slice(part, win + local,
                                                (off, z)), None

            partial, _ = lax.scan(step, partial, (stacked, offs[:, 0, 0]))
        else:
            for b in range(n_bands):
                plan = jax.tree_util.tree_map(
                    lambda a: a[0, 0] if chunked else a[b, 0],
                    stacked[b] if chunked else stacked)
                local = _band_matmul(kind, plan, B).astype(partial.dtype)
                off = offs[b, 0, 0]
                z = jnp.zeros((), off.dtype)
                win = lax.dynamic_slice(partial, (off, z),
                                        (band_rows, partial.shape[1]))
                partial = lax.dynamic_update_slice(partial, win + local,
                                                   (off, z))
        return beta * C + alpha * lax.psum(partial, axis)[:m]

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, axis), P(None, axis), P(), P(), P(), P()),
        out_specs=P(), check_vma=True))


@functools.lru_cache(maxsize=None)
def _um_mode1_program(mesh: Mesh, axis: str, kind: str):
    # `plans` is a TUPLE of band pytrees: a streaming chunk of
    # `_stream_chunk()` bands runs in one dispatch (jit retraces per
    # tuple length, so at most two programs exist: full chunk + tail)
    def fn(plans, B_blk, alpha):
        return alpha * jnp.concatenate(
            [_band_matmul(kind, p, B_blk) for p in plans], axis=0)

    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(None, axis), P()),
        out_specs=P(None, axis), check_vma=True))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _band_slices(hs: HostResidentShards, mesh: Mesh, axis: str):
    """Per-dispatch operands: (bands, offsets) where `bands` is a TUPLE of
    `_stream_chunk()` per-band plan pytrees (each with a leading
    n_bands=1 axis on device) and `offsets` covers the chunk — streamed
    (async device_put from pinned host) or served from the tuned
    prefetch.  One dispatch (and one psum) serves the whole chunk."""
    G = _stream_chunk()
    offs_spec = NamedSharding(mesh, P(None, axis, None))
    if hs.tuned:
        stacked, offs = hs._device
        for c0 in range(0, hs.n_bands, G):
            hi = min(c0 + G, hs.n_bands)
            yield (tuple(jax.tree_util.tree_map(lambda a: a[b:b + 1],
                                                stacked)
                         for b in range(c0, hi)),
                   offs[c0:hi])
        return
    spec = NamedSharding(mesh, P(None, axis), memory_kind="device")
    pending = []
    for c0 in range(0, hs.n_bands, G):
        hi = min(c0 + G, hs.n_bands)
        bands = tuple(jax.device_put(hs.bands[b], spec)
                      for b in range(c0, hi))
        offs = jax.device_put(
            jnp.asarray(hs.offsets[c0:hi, :, None], jnp.int32), offs_spec)
        pending.append(bands)
        if len(pending) > _INFLIGHT:
            jax.block_until_ready(pending.pop(0))
        yield bands, offs


def spmv_um_dist(hs: HostResidentShards, x, alpha, beta, y, mesh: Mesh,
                 axis: str = DEFAULT_AXIS, tuning: bool = False):
    """y' = beta*y + alpha*A@x, A host-resident + nnz-sharded over `mesh`
    (reference sblas_spmv_csr_v1 over managed memory, spmv_um.h:35-139)."""
    require(hs.n_shards == mesh.shape[axis], PartitionError,
            f"shards built for {hs.n_shards}, mesh has {mesh.shape[axis]}")
    require(x.shape[0] == hs.shape[1], ShapeError,
            f"A width {hs.shape[1]} != x length {x.shape[0]}")
    prog = _um_dist_spmv_program(mesh, axis, hs.kind, hs.shape[0],
                                 hs.band_rows)
    if tuning:
        hs.apply_gpu_tuning(mesh, axis)
        stacked, offs = hs._device
        return prog(stacked, offs, x, y, alpha, beta)
    out, b_eff = y, beta
    for band, offs in _band_slices(hs, mesh, axis):
        out = prog(band, offs, x, out, alpha, b_eff)
        b_eff = 1.0
    return out


def spmm_um_dist(hs: HostResidentShards, B, alpha, beta, C, mesh: Mesh,
                 axis: str = DEFAULT_AXIS, tuning: bool = False):
    """C' = beta*C + alpha*A@B, A host-resident + nnz-sharded over `mesh`
    (reference sblas_spmm_csr_v2 over managed memory, spmm_um.h:163-284)."""
    require(hs.n_shards == mesh.shape[axis], PartitionError,
            f"shards built for {hs.n_shards}, mesh has {mesh.shape[axis]}")
    require(B.shape[0] == hs.shape[1], ShapeError,
            f"A width {hs.shape[1]} != B height {B.shape[0]}")
    prog = _um_dist_spmm_program(mesh, axis, hs.kind, hs.shape[0],
                                 hs.band_rows)
    if tuning:
        hs.apply_gpu_tuning(mesh, axis)
        stacked, offs = hs._device
        return prog(stacked, offs, B, C, alpha, beta)
    out, b_eff = C, beta
    for band, offs in _band_slices(hs, mesh, axis):
        out = prog(band, offs, B, out, alpha, b_eff)
        b_eff = 1.0
    return out


def spmm_um_mode1(hp, B, alpha, beta, C, mesh: Mesh,
                  axis: str = DEFAULT_AXIS, tuning: bool = False):
    """C' = beta*C + alpha*A@B, A host-resident, B/C column-sharded — the
    v1 strategy (zero collectives, spmm.h:83-161) with A streamed from
    host DRAM band by band.  `hp` is a single-chip HostResidentPlan; each
    band is replicated to every device, which multiplies it against its
    own K/n column slice."""
    require(B.shape[0] == hp.shape[1], ShapeError,
            f"A width {hp.shape[1]} != B height {B.shape[0]}")
    nd = mesh.shape[axis]
    k = B.shape[1]
    k_pad = -(-k // nd) * nd
    B_p = jnp.pad(B, ((0, 0), (0, k_pad - k)))
    prog = _um_mode1_program(mesh, axis, hp.kind)
    rep = NamedSharding(mesh, P(), memory_kind="device")
    # tuning=True prefetches every band replicated across the mesh before
    # the compute loop (applyGpuTuning analog); tuning=False streams with a
    # bounded in-flight window, `_stream_chunk()` bands per dispatch
    dev_bands = ([jax.device_put(b, rep) for b in hp.bands]
                 if tuning else None)
    if tuning:
        jax.block_until_ready(dev_bands)
    G = _stream_chunk()
    parts = []
    pending = []
    for c0 in range(0, hp.n_bands, G):
        chunk = tuple(
            dev_bands[i] if tuning else jax.device_put(hp.bands[i], rep)
            for i in range(c0, min(c0 + G, hp.n_bands)))
        parts.append(prog(chunk, B_p, alpha))
        pending.append(parts[-1])
        if len(pending) > _INFLIGHT:
            jax.block_until_ready(pending.pop(0))
    ab = jnp.concatenate(parts, axis=0)[: hp.shape[0], :k]
    return beta * C + ab
