"""Host-DRAM-resident operands streamed into HBM (the UM-analog subsystem).

Rebuild of the reference's CUDA Unified-Memory stack
(matrix_um.h / spmm_um.h / spmv_um.h): where the reference allocates
managed memory (`SAFE_ALOC_MANAGED`, utility.h:126-127) and steers page
residency with `cudaMemAdvise`/`cudaMemPrefetchAsync`
(applyGpuTuning/removeGpuTuning/applyCpuTuning, matrix_um.h:529-614), the
equivalent here is explicit placement in the `pinned_host` memory space plus
a **band-streaming executor**: the sparse operand is split into row bands
sized to an HBM budget, bands are DMA'd host->HBM *inside* the jitted chunk
program (in-jit `device_put`) so XLA's latency-hiding scheduler overlaps
each band's transfer with the previous band's compute, and a sliding
window bounds resident HBM.

API parity with the reference's UM surface:

* `HostResidentPlan`       <- the `*_um` containers (matrix_um.h:122-1075)
* `.apply_gpu_tuning()`    <- applyGpuTuning (prefetch to device and keep)
* `.remove_gpu_tuning()`   <- removeGpuTuning (drop device copies)
* `.apply_cpu_tuning()`    <- applyCpuTuning (host-resident, the default)
* `spmm_um` / `spmv_um`    <- sblas_spmm_csr_v2/spmv_v1 with the trailing
                              `tuning` flag (spmm_um.h:167,185-187)

With `tuning=True` the whole operand is prefetched once and compute runs
entirely from HBM — the reference's tuned mode; with `tuning=False` bands
stream on demand — the reference's fault-driven mode, minus the faults.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops.bsr import BsrPlan, spmm_bsr, spmv_bsr
from ..ops.plans import EllPlan
from ..ops.spmm import spmm_coo, spmm_ell
from ..ops.spmv import spmv_coo, spmv_ell
from ..ops.wcoo import spmm_wcoo, spmv_wcoo
from ..utils.errors import PartitionError

# Bands kept in flight during streaming (band i+2 transfers while band i
# computes — the double-buffer depth of the reference's prefetch pipeline).
_INFLIGHT = 3


def _stream_chunk() -> int:
    """Bands batched into ONE dispatch during untuned streaming.

    Each streamed band normally costs one program dispatch; grouping G
    bands per dispatch divides that count by G at the price of a
    G-band-resident HBM window and a larger compiled program — G is
    clamped to the same cap that bounds the unrolled tuned programs.
    Read per call so tests and benchmarks can set it
    (experiments/stream_chunk_sweep.py sweeps it).  Default 8: not
    measured on the H100."""
    g = max(int(os.environ.get("SBLAS_STREAM_CHUNK", "8")), 1)
    return min(g, _UNROLL_MAX_BANDS)

# Windowed-COO band fallback: if tile-splitting stores more than this many
# slots per true nnz across all bands, plain COO bands stream less data.
_WCOO_BAND_FILL_LIMIT = 8.0


def _host_sharding():
    dev = jax.devices()[0]
    return jax.sharding.SingleDeviceSharding(dev, memory_kind="pinned_host")


def _device_sharding():
    dev = jax.devices()[0]
    return jax.sharding.SingleDeviceSharding(dev, memory_kind="device")


def _to_host(tree):
    return jax.device_put(tree, _host_sharding())


def _to_device(tree):
    return jax.device_put(tree, _device_sharding())


@dataclasses.dataclass
class HostResidentPlan:
    """Row-band-partitioned plan, bands pinned in host DRAM.

    `bands[i]` covers rows [i*band_rows, (i+1)*band_rows); all bands share
    one static shape (the last is padded) so a single compiled kernel
    serves every band."""

    bands: List  # per-band plan pytrees (BsrPlan or EllPlan), pinned host
    band_rows: int
    shape: tuple
    nnz: int
    kind: str  # "bsr" | "ell"
    _device_bands: Optional[List] = None
    _stacked: Optional[object] = None  # build-once scan operand (tuned mode)

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    @property
    def tuned(self) -> bool:
        return self._device_bands is not None

    # --- residency control (reference matrix_um.h:529-614) ---
    def apply_gpu_tuning(self) -> None:
        """Prefetch every band to HBM and keep it there.

        The stacked scan operand is built (and paid for) once here, not on
        every tuned op call — re-stacking per call would copy the whole
        operand and transiently double resident HBM in the
        build-once/run-many path."""
        if self._device_bands is None:
            self._device_bands = [_to_device(b) for b in self.bands]
            jax.block_until_ready(self._device_bands)
        if self._stacked is None:
            import jax.tree_util as jtu
            self._stacked = jtu.tree_map(lambda *xs: jnp.stack(xs),
                                         *self._device_bands)
            jax.block_until_ready(self._stacked)
            # individual band copies are no longer needed in tuned mode;
            # keep only the stacked operand resident
            self._device_bands = [None] * len(self.bands)

    def remove_gpu_tuning(self) -> None:
        """Drop HBM copies; bands stay pinned in host DRAM."""
        self._device_bands = None
        self._stacked = None

    def apply_cpu_tuning(self) -> None:
        """Alias of remove_gpu_tuning for reference API parity."""
        self.remove_gpu_tuning()

    def band_device(self, i: int):
        """Band i, on device: prefetched copy when tuned, fresh async DMA
        from pinned host otherwise (tuned mode keeps only the stacked
        operand, so per-band requests re-DMA).  The untuned streaming
        path no longer uses this — its transfers happen in-jit
        (`_bands_to_hbm`); kept for ad-hoc single-band inspection."""
        if self._device_bands is not None and self._device_bands[i] is not None:
            return self._device_bands[i]
        return _to_device(self.bands[i])


def _choose_band_kind(A: CsrMatrix, config: SBlasConfig) -> str:
    """BSR when block-friendly, ELL when rows are balanced, windowed-COO
    otherwise — ANY CSR streams (the reference's UM stack accepts any
    matrix, matrix_um.h:122-614)."""
    from ..ops.bsr import bell_stats
    if (bell_stats(A, config.bsr_block)["blowup"]
            <= config.bsr_blowup_limit):
        return "bsr"
    if EllPlan.is_profitable(A, config):
        return "ell"
    return "wcoo"


def host_resident_plan(A: CsrMatrix, dtype=jnp.float32,
                       hbm_budget_bytes: int = 256 << 20,
                       config: SBlasConfig = DEFAULT,
                       kind: str = None) -> HostResidentPlan:
    """Build a band-partitioned, host-pinned plan for matrix A.

    Band height is chosen so one band's arrays fit in
    `hbm_budget_bytes / _INFLIGHT` (the sliding-window working set).
    `kind` in {"bsr", "ell", "wcoo", "coo", None}; None picks by structure
    (wcoo is the universal unstructured layout; coo is the fallback when
    wcoo's tile-splitting blows up on huge empty-row gaps)."""
    from ..ops.bsr import bell_stats
    m, n = A.shape
    itemsize = jnp.dtype(dtype).itemsize
    kind = kind or _choose_band_kind(A, config)
    nnz_per_row = A.nnz / max(m, 1)
    budget = hbm_budget_bytes / _INFLIGHT

    if kind == "bsr":
        R, C = config.bsr_block
        st = bell_stats(A, config.bsr_block)
        bytes_per_brow = st["slots"] * R * C * (itemsize + 4 / (R * C))
        brows_per_band = max(int(budget // max(bytes_per_brow, 1)), 1)
        band_rows = brows_per_band * R
    elif kind == "ell":
        L = max(int(A.row_nnz.max()), 1)
        bytes_per_row = L * (itemsize + 4)
        band_rows = max(int(budget // max(bytes_per_row, 1)), 8)
        band_rows = (band_rows // 8) * 8
    else:  # wcoo / coo: ~nnz-proportional layouts
        slot_bytes = (itemsize + 12) if kind == "wcoo" else (itemsize + 8)
        bytes_per_row = max(nnz_per_row, 0.1) * slot_bytes * 1.4
        band_rows = max(int(budget // max(bytes_per_row, 1)), 128)
        band_rows = (band_rows // 128) * 128

    band_rows = min(band_rows, max(m, 1))
    n_bands = -(-m // band_rows) if m else 1

    # slice A into row bands (empty tail rows pad the last band)
    band_csrs = []
    for i in range(n_bands):
        r0, r1 = i * band_rows, min((i + 1) * band_rows, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                             np.full(band_rows - (r1 - r0), hi - lo,
                                     dtype=A.row_ptr.dtype)])
        band_csrs.append(CsrMatrix(rp, A.col_idx[lo:hi], A.values[lo:hi],
                                   (band_rows, n)))

    kind, dim = probe_band_dims(band_csrs, kind, A.nnz, config)

    # build every band in host numpy, then one put to pinned host per band —
    # never bouncing through device HBM
    host = _host_sharding()

    def put(arr):
        return jax.device_put(arr, host)

    bands = [build_band_plan(sub, kind, dim, band_rows, n, A.nnz, dtype,
                             config, put) for sub in band_csrs]
    return HostResidentPlan(bands=bands, band_rows=band_rows,
                            shape=A.shape, nnz=A.nnz, kind=kind)


def probe_band_dims(band_csrs, kind: str, total_nnz: int,
                    config: SBlasConfig):
    """Common static layout dimension across bands (max slots / ELL width /
    tile count / padded nnz) — every band must share ONE static shape so a
    single compiled kernel serves all of them.  Returns (kind, dim);
    `kind` may fall back from wcoo to coo when tile-splitting blows up."""
    if kind == "bsr":
        from ..ops.bsr import bell_stats
        return kind, max(max(bell_stats(sub, config.bsr_block)["slots"]
                             for sub in band_csrs), 1)
    if kind == "ell":
        return kind, max(max(int(sub.row_nnz.max()) if sub.nnz else 1
                             for sub in band_csrs), 1)
    if kind == "wcoo":
        from ..ops.wcoo import wcoo_tile_count
        tiles = [wcoo_tile_count(sub) for sub in band_csrs]
        if sum(tiles) * 128 <= _WCOO_BAND_FILL_LIMIT * max(total_nnz, 1):
            return kind, max(tiles)
        kind = "coo"  # pathological tile-splitting: fall back
    if kind == "coo":
        nt = config.nnz_tile
        return kind, max(-(-max(sub.nnz for sub in band_csrs) // nt) * nt,
                         nt)
    raise PartitionError(f"unknown band kind {kind!r}")


def build_band_plan(sub: CsrMatrix, kind: str, dim: int, band_rows: int,
                    n: int, total_nnz: int, dtype, config: SBlasConfig,
                    put):
    """One band of a host-resident plan: `sub` is the (band_rows, n) local
    CSR, `dim` the shared static dimension from `probe_band_dims`, `put`
    the placement function (pinned host here; the distributed layer stacks
    numpy first).  Every band carries IDENTICAL static metadata (shape,
    nnz) — meta fields key the jit cache, and per-band values would force
    one full kernel compile per band."""
    np_val_dtype = np.dtype(jnp.dtype(dtype).name)
    if kind == "bsr":
        from ..ops.bsr import bell_arrays
        R, C = config.bsr_block
        vals, bcol = bell_arrays(sub, config.bsr_block)
        n_brows_t = -(-band_rows // R)
        vals = np.pad(vals, ((0, n_brows_t - vals.shape[0]),
                             (0, dim - vals.shape[1]),
                             (0, 0), (0, 0))).astype(np_val_dtype)
        bcol = np.pad(bcol, ((0, n_brows_t - bcol.shape[0]),
                             (0, dim - bcol.shape[1])))
        return BsrPlan(put(vals), put(bcol.astype(np.int32)),
                       (band_rows, n), total_nnz, config.bsr_block)
    if kind == "ell":
        from ..ops.plans import ell_arrays
        cols, vals = ell_arrays(sub)
        m_pad_t = -(-band_rows // 8) * 8
        cols = np.pad(cols, ((0, m_pad_t - cols.shape[0]),
                             (0, dim - cols.shape[1])))
        vals = np.pad(vals, ((0, m_pad_t - vals.shape[0]),
                             (0, dim - vals.shape[1])))
        return EllPlan(put(cols.astype(np.int32)),
                       put(vals.astype(np_val_dtype)),
                       (band_rows, n), total_nnz)
    if kind == "wcoo":
        from ..ops.wcoo import WcooPlan, wcoo_arrays
        r = wcoo_arrays(sub, min_tiles=dim)
        return WcooPlan(
            cols=put(r["cols"]), rows=put(r["rows"]),
            vals=put(r["vals"].astype(np_val_dtype)),
            shape=(band_rows, n), nnz=total_nnz, n_tiles=r["n_tiles"])
    if kind == "coo":
        from ..ops.plans import CooPlan
        coo = sub.to_coo()
        pad = dim - sub.nnz
        rows = np.concatenate([coo.row_idx,
                               np.full(pad, band_rows - 1, np.int64)])
        cols = np.concatenate([coo.col_idx, np.zeros(pad, np.int64)])
        vals = np.concatenate([coo.values, np.zeros(pad, coo.values.dtype)])
        return CooPlan(put(rows.astype(np.int32)),
                       put(cols.astype(np.int32)),
                       put(vals.astype(np_val_dtype)),
                       (band_rows, n), total_nnz)
    raise PartitionError(f"unknown band kind {kind!r}")


def _band_matmul(kind: str, band_plan, B):
    z = jnp.zeros((band_plan.shape[0], B.shape[1]), band_plan.vals.dtype)
    fn = {"bsr": spmm_bsr, "ell": spmm_ell, "wcoo": spmm_wcoo,
          "coo": spmm_coo}[kind]
    return fn(band_plan, B, 1.0, 0.0, z)


def _band_matvec(kind: str, band_plan, x):
    z = jnp.zeros(band_plan.shape[0], band_plan.vals.dtype)
    fn = {"bsr": spmv_bsr, "ell": spmv_ell, "wcoo": spmv_wcoo,
          "coo": spmv_coo}[kind]
    return fn(band_plan, x, 1.0, 0.0, z)


def _stream(hplan: HostResidentPlan, chunk_op):
    """Run `chunk_op` (a jitted function of a TUPLE of PINNED-HOST bands)
    over all bands with a bounded in-flight window.

    The host->HBM transfers happen INSIDE the jitted chunk program
    (in-jit `jax.device_put`, see `_bands_to_hbm`), so one dispatch per
    `_stream_chunk()` bands covers transfers AND compute and XLA's
    latency-hiding scheduler does the overlap.  The block_until_ready
    pacing bounds how far the HOST runs ahead.  Each chunk program holds
    G bands at once, so peak HBM can exceed the budget (sized for
    _INFLIGHT single bands): the budget is a target, not a hard cap."""
    G = _stream_chunk()
    parts = []
    pending = []
    for c0 in range(0, hplan.n_bands, G):
        chunk = tuple(hplan.bands[i]
                      for i in range(c0, min(c0 + G, hplan.n_bands)))
        parts.append(chunk_op(chunk))
        pending.append(parts[-1])
        if len(pending) >= _INFLIGHT:
            jax.block_until_ready(pending.pop(0))
    return parts


def _bands_to_hbm(bands):
    """In-jit host->HBM placement of a tuple of pinned-host band pytrees.

    Traced inside the chunk programs: XLA sees the copy and the band
    kernel in ONE program and schedules the next band's DMA under the
    current band's compute (the untuned streaming pipeline)."""
    dsh = _device_sharding()
    return tuple(jax.tree_util.tree_map(
        lambda a: jax.device_put(a, dsh), b) for b in bands)


@partial(jax.jit, static_argnames=("kind",))
def _chunk_matmul(kind, bands, B):
    return jnp.concatenate([_band_matmul(kind, b, B)
                            for b in _bands_to_hbm(bands)], axis=0)


@partial(jax.jit, static_argnames=("kind",))
def _chunk_matvec(kind, bands, x):
    return jnp.concatenate([_band_matvec(kind, b, x)
                            for b in _bands_to_hbm(bands)])


def _stacked_bands(hplan: HostResidentPlan):
    """Tuned-mode fast path: bands share identical static shapes by
    construction, so the HBM-resident copies stack into one pytree and
    the whole band loop runs in a single jitted program — one dispatch
    instead of one per band.  Built once in apply_gpu_tuning and cached
    on the plan."""
    return hplan._stacked


# Band-loop unroll cap: the unrolled program is linear in band count.
# Above the cap we fall back to lax.scan, whose program size stays O(1).
_UNROLL_MAX_BANDS = 24


@partial(jax.jit, static_argnames=("kind", "m"))
def _spmm_tuned(kind, stacked, B, alpha, beta, C, m):
    # UNROLLED over bands (n_bands is static) up to the cap, so each band
    # kernel's gathers stay flat rather than inside a loop body
    n_bands = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    if n_bands > _UNROLL_MAX_BANDS:
        def step(_, band):
            return None, _band_matmul(kind, band, B)

        _, parts = jax.lax.scan(step, None, stacked)
        ab = parts.reshape(-1, B.shape[1])[:m]
        return beta * C + alpha * ab
    parts = [_band_matmul(kind,
                          jax.tree_util.tree_map(lambda a: a[i], stacked),
                          B)
             for i in range(n_bands)]
    ab = jnp.concatenate(parts, axis=0)[:m]
    return beta * C + alpha * ab


@partial(jax.jit, static_argnames=("kind", "m"))
def _spmv_tuned(kind, stacked, x, alpha, beta, y, m):
    # unrolled over bands with the same scan fallback — see _spmm_tuned
    n_bands = jax.tree_util.tree_leaves(stacked)[0].shape[0]
    if n_bands > _UNROLL_MAX_BANDS:
        def step(_, band):
            return None, _band_matvec(kind, band, x)

        _, parts = jax.lax.scan(step, None, stacked)
        return beta * y + alpha * parts.reshape(-1)[:m]
    parts = [_band_matvec(kind,
                          jax.tree_util.tree_map(lambda a: a[i], stacked),
                          x)
             for i in range(n_bands)]
    return beta * y + alpha * jnp.concatenate(parts)[:m]


def spmm_um(hplan: HostResidentPlan, B, alpha, beta, C,
            tuning: bool = False):
    """C' = beta*C + alpha*A@B with A host-DRAM-resident.

    Signature parity with the reference's sblas_spmm_csr UM variants
    (spmm_um.h:167: trailing `tuning` selects prefetched residency)."""
    if tuning:
        hplan.apply_gpu_tuning()
        return _spmm_tuned(hplan.kind, _stacked_bands(hplan), B,
                           alpha, beta, C, hplan.shape[0])
    parts = _stream(hplan, lambda bands: _chunk_matmul(hplan.kind, bands, B))
    ab = jnp.concatenate(parts, axis=0)[: hplan.shape[0]]
    return beta * C + alpha * ab


def spmv_um(hplan: HostResidentPlan, x, alpha, beta, y,
            tuning: bool = False):
    """y' = beta*y + alpha*A@x with A host-DRAM-resident
    (reference spmv_um.h:39,51-53)."""
    if tuning:
        hplan.apply_gpu_tuning()
        return _spmv_tuned(hplan.kind, _stacked_bands(hplan), x,
                           alpha, beta, y, hplan.shape[0])
    parts = _stream(hplan, lambda bands: _chunk_matvec(hplan.kind, bands, x))
    ax = jnp.concatenate(parts)[: hplan.shape[0]]
    return beta * y + alpha * ax
