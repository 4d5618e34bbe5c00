"""Unit-test driver — the reference's unit_test binary surface.

    python -m sblas.cli.unit_test [A.mtx]

Runs the same sequence as unit_test.cu:177-187: container construction
smoke tests (COO/CSR/CSC/Dense, :20-64), SpMM both strategies and SpMV with
the hardcoded shapes n_dev=4, alpha=3, beta=4, b_width=256 (:66-175) — but
the exit code reflects validation (the reference returns 0 even on failure,
a documented quirk; SURVEY.md §7).
"""

from __future__ import annotations

import os
import sys

DEFAULT_MTX = "/root/reference/ash85.mtx"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DEFAULT_MTX
    if not os.path.exists(path):
        print(f"fixture {path} missing; generating a synthetic one")
        from ..io.generate import pattern_symmetric
        from ..io.mmio import write_mtx
        gen = pattern_symmetric()
        coo = gen.to_coo()
        path = "/tmp/sblas_unit_fixture.mtx"
        write_mtx(path, *gen.shape, coo.row_idx, coo.col_idx, coo.values)

    from .common import setup_devices
    mesh, n = setup_devices(4)

    import jax.numpy as jnp
    import numpy as np

    from ..containers import (CooMatrix, CscMatrix, CsrMatrix, DenseMatrix,
                              DenseVector)
    from ..ops import make_plan
    from ..ops.cpu_reference import spmm_cpu, spmv_cpu
    from ..parallel import spmm_mode1, spmm_mode2, spmv_dist, sync_to_host
    from ..partition import partition_nnz_balanced
    from ..utils.verify import check_equal

    ok = True

    def report(name, passed):
        nonlocal ok
        ok &= bool(passed)
        print(f"{name}: {'PASS' if passed else 'FAIL'}")

    # container smoke tests (unit_test.cu:20-64), with real assertions
    coo = CooMatrix.from_mtx(path)
    report("cooMatrixTest", coo.nnz > 0 and coo.sort_by_row().nnz == coo.nnz)
    csr = CsrMatrix.from_mtx(path)
    report("csrMatrixTest", csr.nnz > 0 and csr.row_ptr[-1] == csr.nnz)
    csc = CscMatrix.from_csr(csr)
    report("cscMatrixTest",
           csc.nnz == csr.nnz
           and np.allclose(csc.to_csr().to_dense(), csr.to_dense()))
    dm = DenseMatrix.random(csr.height, 16)
    report("denseMatrixTest",
           np.allclose(dm.transpose().values, dm.values.T))

    # op tests (unit_test.cu:66-175): alpha=3 beta=4 b_width=256 n=4
    alpha, beta, b_width = 3.0, 4.0, 256
    B = DenseMatrix.random(csr.width, b_width)
    C = DenseMatrix.constant(csr.height, b_width, 1.0)
    x = DenseVector.random(csr.width)
    y = DenseVector.constant(csr.height, 1.0)
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)
    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    want_mm = spmm_cpu(csr, B, alpha, beta, C)
    want_mv = spmv_cpu(csr, x, alpha, beta, y)
    dt = Bd.dtype

    plan = make_plan(csr, dtype=dt)
    segs = partition_nnz_balanced(csr, n, dtype=dt)
    rel = dt == jnp.float32
    got = spmm_mode1(plan, Bd, alpha, beta, Cd, mesh)
    report("spmmCsrTest (mode 1)",
           check_equal(sync_to_host(got), want_mm, relative=rel).ok)
    got = spmm_mode2(segs, Bd, alpha, beta, Cd, mesh)
    report("spmmCsrTest2 (mode 2)",
           check_equal(sync_to_host(got), want_mm, relative=rel).ok)
    got = spmv_dist(segs, xd, alpha, beta, yd, mesh)
    report("spmvCsrTest",
           check_equal(sync_to_host(got), want_mv, relative=rel).ok)

    print(f"Validation = {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
