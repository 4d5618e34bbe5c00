"""UM-analog SpMM driver — argv contract of the reference's spmm_test_um.

    python -m sblas.cli.spmm_test_um <method 1|2> <A.mtx> <B_width>
                                         <alpha> <beta> <n_devices>
                                         [tuning 0|1] [f32|f64]

Mirrors spmm_test_um.cu:165-190: same shape as spmm_test plus the trailing
`tuning` flag.  The matrix is host-DRAM-resident (pinned) and streamed into
HBM per band; tuning=1 prefetches it wholly to HBM first (the reference's
cudaMemAdvise/cudaMemPrefetchAsync mode, matrix_um.h:529-564).

With n_devices > 1 the method argument selects the real distribution
strategy over a device mesh (reference spmm_um.h:163-284): method 1
replicates the host-resident A band-by-band against column-sharded B/C
(zero collectives); method 2 nnz-shards A with one psum of the partial C.
SBLAS_HBM_BUDGET (bytes, default 256 MiB) caps resident HBM per device.
"""

from __future__ import annotations

import sys

from .common import finish, positional, setup_devices

USAGE = ("usage: python -m sblas.cli.spmm_test_um "
         "<method 1|2> <A.mtx> <B_width> <alpha> <beta> <n_devices> "
         "[tuning 0|1] [f32|f64]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    method, path, b_width, alpha, beta, n_dev = positional(
        argv, range(6), (int, str, int, float, float, int), USAGE)
    tuning = bool(int(argv[6])) if len(argv) > 6 else False
    dtype_name = argv[7] if len(argv) > 7 else "f32"

    from .common import ensure_dtype
    ensure_dtype(dtype_name)
    setup_devices(n_dev)

    import jax.numpy as jnp
    import numpy as np

    from ..containers import CsrMatrix, DenseMatrix, MajorOrder
    from ..memory import host_resident_plan, spmm_um
    from ..ops.cpu_reference import spmm_cpu
    from ..utils.timing import gflops, spmm_flops, timed
    from ..utils.verify import check_equal

    np_dtype = np.float64 if dtype_name == "f64" else np.float32
    jnp_dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    times: dict = {}
    import os
    budget = int(os.environ.get("SBLAS_HBM_BUDGET", 256 << 20))

    with timed("Load time", times):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        B = DenseMatrix.random(A.width, b_width, order=MajorOrder.COL_MAJOR,
                               dtype=np_dtype)
        C = DenseMatrix.constant(A.height, b_width, 1.0, dtype=np_dtype)

    # method 1 = partition dense B (A replicated, streamed from host);
    # method 2 = partition sparse A (nnz-balanced shards, psum of partials)
    if n_dev > 1:
        from ..memory import (host_resident_shards, spmm_um_dist,
                              spmm_um_mode1)
        from ..parallel import make_mesh
        mesh = make_mesh(n_dev)
        if method == 1:
            with timed("Distribution time", times):
                hp = host_resident_plan(A, dtype=jnp_dtype,
                                        hbm_budget_bytes=budget)
            run = lambda Bd, Cd: spmm_um_mode1(  # noqa: E731
                hp, Bd, alpha, beta, Cd, mesh, tuning=tuning)
            n_bands, band_rows, kind = hp.n_bands, hp.band_rows, hp.kind
        else:
            with timed("Distribution time", times):
                hs = host_resident_shards(A, n_dev, dtype=jnp_dtype,
                                          hbm_budget_bytes=budget)
            run = lambda Bd, Cd: spmm_um_dist(  # noqa: E731
                hs, Bd, alpha, beta, Cd, mesh, tuning=tuning)
            n_bands, band_rows, kind = hs.n_bands, hs.band_rows, hs.kind
    else:
        with timed("Distribution time", times):
            hp = host_resident_plan(A, dtype=jnp_dtype,
                                    hbm_budget_bytes=budget)
        run = lambda Bd, Cd: spmm_um(  # noqa: E731
            hp, Bd, alpha, beta, Cd, tuning=tuning)
        n_bands, band_rows, kind = hp.n_bands, hp.band_rows, hp.kind
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, K={b_width}, "
          f"{n_dev} device(s), method {method}, "
          f"{n_bands} band(s) x {band_rows} rows [{kind}], "
          f"tuning={int(tuning)}")

    from .common import steady_run_ms
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)
    run(Bd, Cd)  # compile+warm
    # streaming is a host band loop (per-dispatch cost is real):
    # async-batch estimator, no device-side timing loop
    ms, got, _ = steady_run_ms(lambda: run(Bd, Cd))
    times["Run time"] = ms
    print(f"GFLOPS = {gflops(spmm_flops(A.nnz, b_width), ms):.3f}")

    with timed("CPU run time", times):
        want = spmm_cpu(A, B, alpha, beta, C)
    report = check_equal(np.asarray(got), want,
                         relative=(np_dtype == np.float32))
    print(report)
    return finish(report.ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
