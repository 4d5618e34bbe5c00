"""Host-DRAM-resident DENSE operands: HBM-exceeding B and C for SpMM.

The reference's UM stack places the dense containers in managed memory
with the same tuning lifecycle as the sparse ones (DenseMatrix_um /
DenseVector_um, matrix_um.h:735-814, applyGpuTuning :793-814): an SpMM
whose C (m x K) exceeds device memory simply faults pages in and out.
The analog here is explicit: `HostDense` pins the array in host DRAM, and
`spmm_um_hostdense` runs over a 2-D grid of host-resident sparse cells —
row bands x column chunks — streaming

    one A cell + one B column-chunk + one C row-band

through HBM at a time, so resident bytes stay under the budget no matter
how large m*K or n*K grow.  Empty cells (banded matrices leave most of
the grid vacant) are skipped at dispatch time; all built cells share one
static shape, so a single compiled kernel serves the whole grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..utils.errors import ShapeError, require
from .host import (_INFLIGHT, _band_matmul, _choose_band_kind,
                   _device_sharding, _host_sharding, _to_device,
                   build_band_plan, probe_band_dims)


@dataclasses.dataclass
class HostDense:
    """Dense operand pinned in host DRAM (DenseMatrix_um analog).

    `apply_gpu_tuning` prefetches the whole array to HBM (only valid when
    it fits — the reference's prefetch mode has the same caveat);
    `chunk(lo, hi)` DMAs one row range to the device."""

    values: jax.Array  # pinned host
    shape: Tuple[int, ...]
    _device: Optional[jax.Array] = None
    _host_np: Optional[np.ndarray] = None  # cached numpy view for slicing

    @classmethod
    def from_array(cls, arr) -> "HostDense":
        host = jax.device_put(np.asarray(arr), _host_sharding())
        return cls(values=host, shape=tuple(arr.shape))

    @property
    def tuned(self) -> bool:
        return self._device is not None

    def apply_gpu_tuning(self) -> None:
        if self._device is None:
            self._device = _to_device(self.values)
            jax.block_until_ready(self._device)

    def remove_gpu_tuning(self) -> None:
        self._device = None

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()

    def chunk(self, lo: int, hi: int) -> jax.Array:
        """Rows [lo, hi) on device (from the prefetched copy when tuned).

        Untuned slicing goes through a cached numpy view: device_put of a
        *sliced* pinned-host jax array keeps a stale <host> memory space
        in its aval (observed jax 0.9 quirk) and then poisons gather."""
        if self._device is not None:
            return self._device[lo:hi]
        if self._host_np is None:
            self._host_np = np.asarray(self.values)
        return _to_device(self._host_np[lo:hi])

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values)


@dataclasses.dataclass
class HostResidentGrid:
    """2-D grid of host-pinned sparse cells: cell (i, j) holds rows
    [i*band_rows, ...) x columns [j*chunk_cols, ...) of A, columns rebased
    to the chunk.  Missing keys are structurally empty cells."""

    cells: Dict[Tuple[int, int], object]
    band_rows: int
    chunk_cols: int
    n_bands: int
    n_chunks: int
    shape: Tuple[int, int]
    nnz: int
    kind: str
    _device_cells: Optional[Dict] = None

    @property
    def tuned(self) -> bool:
        return self._device_cells is not None

    def apply_gpu_tuning(self) -> None:
        if self._device_cells is None:
            self._device_cells = {k: _to_device(v)
                                  for k, v in self.cells.items()}
            jax.block_until_ready(list(self._device_cells.values()))

    def remove_gpu_tuning(self) -> None:
        self._device_cells = None

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()

    def cell_device(self, key):
        if self._device_cells is not None:
            return self._device_cells[key]
        return _to_device(self.cells[key])


def host_resident_grid(A: CsrMatrix, dtype=jnp.float32,
                       hbm_budget_bytes: int = 256 << 20, k: int = 64,
                       config: SBlasConfig = DEFAULT,
                       kind: str = None) -> HostResidentGrid:
    """Build the row-band x column-chunk cell grid for A, sized so one
    cell + one B chunk (chunk_cols x k) + one C band (band_rows x k) fit
    in hbm_budget_bytes / _INFLIGHT together."""
    m, n = A.shape
    itemsize = jnp.dtype(dtype).itemsize
    budget = hbm_budget_bytes / _INFLIGHT
    # split the budget: a third each for the A cell, B chunk, C band
    chunk_cols = max(int((budget / 3) // max(k * itemsize, 1)), 128)
    chunk_cols = min(-(-chunk_cols // 128) * 128, -(-max(n, 1) // 128) * 128)
    band_rows = max(int((budget / 3) // max(k * itemsize, 1)), 128)
    band_rows = min(-(-band_rows // 128) * 128, -(-max(m, 1) // 128) * 128)
    # A-cell density scales with 1/n_chunks; the nnz-proportional kinds
    # stay under budget/3 automatically for any realistic density
    n_bands = -(-m // band_rows) if m else 1
    n_chunks = -(-n // chunk_cols) if n else 1
    kind = kind or _choose_band_kind(A, config)

    # slice cells (sub-CSRs with rebased columns)
    cell_csrs: Dict[Tuple[int, int], CsrMatrix] = {}
    coo = A.to_coo()
    band_of = coo.row_idx // band_rows
    chunk_of = coo.col_idx // chunk_cols
    order = np.lexsort((coo.col_idx, coo.row_idx, chunk_of, band_of))
    key = band_of[order] * n_chunks + chunk_of[order]
    starts = np.searchsorted(key, np.arange(n_bands * n_chunks))
    ends = np.append(starts[1:], len(key))
    for cell_id in np.unique(key):
        i, j = int(cell_id) // n_chunks, int(cell_id) % n_chunks
        sel = order[starts[cell_id]:ends[cell_id]]
        rows = coo.row_idx[sel] - i * band_rows
        cols = coo.col_idx[sel] - j * chunk_cols
        rp = np.zeros(band_rows + 1, dtype=np.int64)
        np.add.at(rp, rows + 1, 1)
        rp = np.cumsum(rp)
        cell_csrs[(i, j)] = CsrMatrix(rp, cols, coo.values[sel],
                                      (band_rows, chunk_cols))

    if not cell_csrs:  # empty matrix: one empty cell keeps shapes defined
        cell_csrs[(0, 0)] = CsrMatrix(
            np.zeros(band_rows + 1, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.dtype(jnp.dtype(dtype).name)),
            (band_rows, chunk_cols))

    kind, dim = probe_band_dims(list(cell_csrs.values()), kind, A.nnz,
                                config)
    host = _host_sharding()

    def put(arr):
        return jax.device_put(arr, host)

    cells = {key: build_band_plan(sub, kind, dim, band_rows, chunk_cols,
                                  A.nnz, dtype, config, put)
             for key, sub in cell_csrs.items()}
    return HostResidentGrid(cells=cells, band_rows=band_rows,
                            chunk_cols=chunk_cols, n_bands=n_bands,
                            n_chunks=n_chunks, shape=A.shape, nnz=A.nnz,
                            kind=kind)


def spmm_um_hostdense(grid: HostResidentGrid, B: HostDense, alpha, beta,
                      C: HostDense, tuning: bool = False) -> HostDense:
    """C' = beta*C + alpha*A@B with A, B AND C host-DRAM-resident
    (reference matrix_um.h:735-814: every container in managed memory).

    Returns a new HostDense C'.  Peak HBM: one A cell + one B chunk + one
    C band (x the in-flight window) regardless of m*K / n*K."""
    m, n = grid.shape
    require(B.shape[0] == n, ShapeError,
            f"A width {n} != B height {B.shape[0]}")
    require(C.shape == (m, B.shape[1]), ShapeError,
            f"C shape {C.shape} != ({m}, {B.shape[1]})")
    if tuning:
        grid.apply_gpu_tuning()
        B.apply_gpu_tuning()
    k = B.shape[1]
    br, cc = grid.band_rows, grid.chunk_cols
    host = _host_sharding()
    out_bands: List = []
    pending: List = []
    for i in range(grid.n_bands):
        r0, r1 = i * br, min((i + 1) * br, m)
        acc = None
        for j in range(grid.n_chunks):
            if (i, j) not in grid.cells:
                continue  # structurally empty cell: no dispatch
            c0, c1 = j * cc, min((j + 1) * cc, n)
            Bj = B.chunk(c0, c1)
            if Bj.shape[0] < cc:
                Bj = jnp.pad(Bj, ((0, cc - Bj.shape[0]), (0, 0)))
            part = _band_matmul(grid.kind, grid.cell_device((i, j)), Bj)
            acc = part if acc is None else acc + part
        Ci = C.chunk(r0, r1)
        band = beta * Ci if acc is None else beta * Ci + alpha * acc[:r1 - r0]
        # offload the finished band back to pinned host immediately
        out_bands.append(jax.device_put(band, host))
        pending.append(out_bands[-1])
        if len(pending) >= _INFLIGHT:
            jax.block_until_ready(pending.pop(0))
    # assemble on the HOST (numpy): a device concatenate would materialize
    # the full m x K result in HBM — the exact thing this path avoids
    result_np = np.concatenate([np.asarray(b) for b in out_bands], axis=0)
    return HostDense(values=jax.device_put(result_np, host), shape=(m, k))


def spmv_um_hostdense(grid: HostResidentGrid, x: HostDense, alpha, beta,
                      y: HostDense, tuning: bool = False) -> HostDense:
    """y' = beta*y + alpha*A@x with A, x AND y host-DRAM-resident
    (reference DenseVector_um, matrix_um.h:918-1075).  Runs the 2-D cell
    grid with a width-1 dense operand."""
    require(x.shape == (grid.shape[1],), ShapeError,
            f"x shape {x.shape} != ({grid.shape[1]},)")
    require(y.shape == (grid.shape[0],), ShapeError,
            f"y shape {y.shape} != ({grid.shape[0]},)")
    x2 = HostDense(values=x.values.reshape(-1, 1), shape=(x.shape[0], 1),
                   _device=(None if x._device is None
                            else x._device.reshape(-1, 1)))
    y2 = HostDense(values=y.values.reshape(-1, 1), shape=(y.shape[0], 1),
                   _device=(None if y._device is None
                            else y._device.reshape(-1, 1)))
    out = spmm_um_hostdense(grid, x2, alpha, beta, y2, tuning=tuning)
    return HostDense(values=out.values.reshape(-1), shape=(grid.shape[0],))
