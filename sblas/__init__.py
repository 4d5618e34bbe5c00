"""sblas — a sparse-BLAS framework in JAX.

Built from scratch in JAX/XLA with the capabilities of the reference
multi-GPU library (tartarughina/S-BLAS; see SURVEY.md): COO/CSR/CSC and dense
containers with Matrix-Market ingestion, CSR SpMV/SpMM kernels, two
distributed execution strategies over a `jax.sharding.Mesh`, a host-DRAM
streaming path for HBM-exceeding operands, and a CPU oracle + tolerance
verification harness.

Unified import surface (analog of the reference's sblas.h:15-21 /
sblas_um.h:15-21 single-include headers).
"""

from .config import DEFAULT, SBlasConfig
from .containers import (CooMatrix, CscMatrix, CsrMatrix, DenseMatrix,
                         DenseVector, MajorOrder, SharePolicy)
from .solvers import SolveResult, bicgstab, cg, \
    jacobi_inv_diag, pagerank
from .utils.verify import VerifyReport, assert_equal, check_equal

__all__ = [
    "DEFAULT", "SBlasConfig",
    "CooMatrix", "CsrMatrix", "CscMatrix", "DenseMatrix", "DenseVector",
    "MajorOrder", "SharePolicy",
    "SolveResult", "bicgstab", "cg", "jacobi_inv_diag", "pagerank",
    "VerifyReport", "assert_equal", "check_equal",
]

__version__ = "0.1.0"
