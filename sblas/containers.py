"""Sparse and dense operand containers.

Re-design of the reference's five container classes
(CooSparseMatrix / CsrSparseMatrix / CscSparseMatrix / DenseMatrix /
DenseVector, matrix.h:118-740).  Key design shifts:

* containers are immutable host-side descriptions (numpy arrays + metadata);
  device placement is a *sharding annotation*, not an eager copy-per-GPU —
  the reference's `sync2gpu(n_gpu, policy)` (matrix.h:341-395) becomes
  `place(policy, mesh, axis)` returning jax.Arrays with a `NamedSharding`,
  and XLA moves bytes lazily/optimally;
* `GpuSharePolicy {none, replicate, segment}` (matrix.h:34) maps to
  `SharePolicy` with the same three members;
* `MajorOrder {row_major, col_major}` (matrix.h:37) is kept as metadata so
  the CLI drivers keep the reference's argv/layout contract, but under XLA
  the logical array is layout-free — XLA picks physical tiling;
* indices are int32 on device, int64 on host.

Loading goes through `sblas.io.mmio`, which fixes the reference's COO
loader quirk (raw fscanf ignoring pattern/symmetric typecodes,
matrix.h:169-176) by sharing the full-semantics reader.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np

from .config import DEFAULT, SBlasConfig
from .io import mmio
from .utils.errors import ShapeError, require


class SharePolicy(enum.Enum):
    """Distribution policy for device placement (reference matrix.h:34)."""
    NONE = "none"
    REPLICATE = "replicate"
    SEGMENT = "segment"


class MajorOrder(enum.Enum):
    """Dense storage order flag (reference matrix.h:37)."""
    ROW_MAJOR = "row_major"
    COL_MAJOR = "col_major"


# ---------------------------------------------------------------------------
# Sparse containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """COO sparse matrix (reference CooSparseMatrix, matrix.h:118-272)."""

    row_idx: np.ndarray  # (nnz,) int64
    col_idx: np.ndarray  # (nnz,) int64
    values: np.ndarray   # (nnz,) value dtype
    shape: Tuple[int, int]

    @classmethod
    def from_mtx(cls, path: str, dtype=np.float64) -> "CooMatrix":
        header, r, c, v = mmio.read_coo(path, value_dtype=dtype)
        return cls(r, c, v, (header.nrows, header.ncols))

    @property
    def nnz(self) -> int:
        return len(self.values)

    @property
    def height(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    def sort_by_row(self) -> "CooMatrix":
        """Stable (row, col) sort (reference sortByRow qsort,
        matrix.h:223-239, made stable and col-secondary)."""
        from .utils.hostmath import lexsort2
        order = lexsort2(self.col_idx, self.row_idx)
        return CooMatrix(self.row_idx[order], self.col_idx[order],
                         self.values[order], self.shape)

    def to_csr(self, sum_duplicates: bool = True) -> "CsrMatrix":
        row_ptr, col_idx, values = mmio.coo_to_csr_arrays(
            self.shape[0], self.row_idx, self.col_idx, self.values,
            sum_duplicates=sum_duplicates)
        return CsrMatrix(row_ptr, col_idx, values, self.shape)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.values.dtype)
        np.add.at(out, (self.row_idx, self.col_idx), self.values)
        return out


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """CSR sparse matrix (reference CsrSparseMatrix, matrix.h:276-453).

    The reference's nnz-balanced `sync2gpu(segment)` partitioner lives in
    `sblas.partition` (planner) + `sblas.parallel` (placement).
    """

    row_ptr: np.ndarray  # (m+1,) int64
    col_idx: np.ndarray  # (nnz,) int64
    values: np.ndarray   # (nnz,)
    shape: Tuple[int, int]

    def __post_init__(self):
        require(len(self.row_ptr) == self.shape[0] + 1, ShapeError,
                f"row_ptr length {len(self.row_ptr)} != m+1 ({self.shape[0] + 1})")
        require(len(self.col_idx) == len(self.values), ShapeError,
                "col_idx / values length mismatch")

    @classmethod
    def from_mtx(cls, path: str, dtype=np.float64) -> "CsrMatrix":
        header, row_ptr, col_idx, values = mmio.read_csr_arrays(
            path, value_dtype=dtype)
        return cls(row_ptr, col_idx, values, (header.nrows, header.ncols))

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CsrMatrix":
        r, c = np.nonzero(dense)
        return CooMatrix(r.astype(np.int64), c.astype(np.int64),
                         dense[r, c], dense.shape).to_csr()

    @property
    def nnz(self) -> int:
        return len(self.values)

    @property
    def height(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def to_coo(self) -> CooMatrix:
        row_idx = np.repeat(np.arange(self.shape[0], dtype=np.int64),
                            self.row_nnz)
        return CooMatrix(row_idx, self.col_idx.copy(), self.values.copy(),
                         self.shape)

    def to_csc(self) -> "CscMatrix":
        return CscMatrix.from_csr(self)

    def to_dense(self) -> np.ndarray:
        return self.to_coo().to_dense()

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(self.row_ptr, self.col_idx,
                         self.values.astype(dtype), self.shape)

    def transpose(self) -> "CsrMatrix":
        """A^T as CSR — structurally CSC(A)'s arrays reinterpreted
        (CSR(A^T).row_ptr == CSC(A).col_ptr), one sort-based pass.
        What a PageRank-style `P^T @ r` build needs (the reference has
        no transpose; its CsrToCsc, matrix.h:40-64, is the same math)."""
        csc = self.to_csc()
        return CsrMatrix(csc.col_ptr, csc.row_idx, csc.values,
                         (self.shape[1], self.shape[0]))


@dataclasses.dataclass(frozen=True)
class CscMatrix:
    """CSC sparse matrix (reference CscSparseMatrix, matrix.h:457-506;
    built only from CSR there — we keep that path and its inverse)."""

    col_ptr: np.ndarray  # (n+1,)
    row_idx: np.ndarray  # (nnz,)
    values: np.ndarray   # (nnz,)
    shape: Tuple[int, int]

    @classmethod
    def from_csr(cls, csr: CsrMatrix) -> "CscMatrix":
        """CSR -> CSC transposition (reference CsrToCsc histogram +
        exclusive-scan + insert, matrix.h:40-64), vectorized."""
        coo = csr.to_coo()
        from .utils.hostmath import lexsort2
        order = lexsort2(coo.row_idx, coo.col_idx)
        row_idx = coo.row_idx[order]
        values = coo.values[order]
        col_sorted = coo.col_idx[order]
        col_ptr = np.zeros(csr.shape[1] + 1, dtype=np.int64)
        np.add.at(col_ptr, col_sorted + 1, 1)
        np.cumsum(col_ptr, out=col_ptr)
        return cls(col_ptr, row_idx, values, csr.shape)

    def to_csr(self) -> CsrMatrix:
        """Inverse conversion (reference CscToCsr, matrix.h:67-91)."""
        col_idx = np.repeat(np.arange(self.shape[1], dtype=np.int64),
                            np.diff(self.col_ptr))
        return CooMatrix(self.row_idx, col_idx, self.values,
                         self.shape).to_csr()

    @property
    def nnz(self) -> int:
        return len(self.values)


# ---------------------------------------------------------------------------
# Dense containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense matrix operand (reference DenseMatrix, matrix.h:510-649).

    `values` is always logically (rows, cols); `order` records the
    reference's row/col-major flag, which under XLA only governs which
    dimension `SEGMENT` placement shards (cols if col-major — the leading
    storage dimension, matching matrix.h:554-568)."""

    values: np.ndarray
    order: MajorOrder = MajorOrder.ROW_MAJOR

    @classmethod
    def random(cls, height: int, width: int,
               order: MajorOrder = MajorOrder.ROW_MAJOR,
               dtype=np.float64,
               config: SBlasConfig = DEFAULT) -> "DenseMatrix":
        """Seeded random fill in [0, 1) (reference matrix.h:519-527 uses
        C rand() with RAND_INIT_SEED 211; we use numpy's generator with the
        same seed value — streams differ, determinism is preserved)."""
        rng = np.random.RandomState(config.rand_seed)
        return cls(rng.random_sample((height, width)).astype(dtype), order)

    @classmethod
    def constant(cls, height: int, width: int, fill: float,
                 order: MajorOrder = MajorOrder.ROW_MAJOR,
                 dtype=np.float64) -> "DenseMatrix":
        """Constant fill (reference matrix.h:529-539)."""
        return cls(np.full((height, width), fill, dtype=dtype), order)

    @property
    def height(self) -> int:
        return self.values.shape[0]

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def segment_axis(self) -> int:
        """Which logical axis SEGMENT placement shards: the leading storage
        dimension (reference first_order/second_order logic,
        matrix.h:554-568): columns for col-major, rows for row-major."""
        return 1 if self.order is MajorOrder.COL_MAJOR else 0

    def transpose(self) -> "DenseMatrix":
        """Logical transpose with order flip (reference host transpose,
        matrix.h:577-593)."""
        flipped = (MajorOrder.COL_MAJOR if self.order is MajorOrder.ROW_MAJOR
                   else MajorOrder.ROW_MAJOR)
        return DenseMatrix(self.values.T.copy(), flipped)


@dataclasses.dataclass(frozen=True)
class DenseVector:
    """Dense vector operand (reference DenseVector, matrix.h:653-740;
    SEGMENT placement is rejected there too — matrix.h:693)."""

    values: np.ndarray

    @classmethod
    def random(cls, length: int, dtype=np.float64,
               config: SBlasConfig = DEFAULT) -> "DenseVector":
        rng = np.random.RandomState(config.rand_seed)
        return cls(rng.random_sample(length).astype(dtype))

    @classmethod
    def constant(cls, length: int, fill: float, dtype=np.float64
                 ) -> "DenseVector":
        return cls(np.full(length, fill, dtype=dtype))

    @property
    def length(self) -> int:
        return len(self.values)
