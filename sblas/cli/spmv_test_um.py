"""UM-analog SpMV driver — argv contract of the reference's spmv_test_um.

    python -m sblas.cli.spmv_test_um <A.mtx> <alpha> <beta> <n_devices>
                                         [tuning 0|1] [f32|f64]

Mirrors spmv_test_um.cu: the spmv_test shape plus the trailing tuning flag
(host-DRAM-resident A, band-streamed; tuning=1 prefetches to HBM).

With n_devices > 1 the host-resident matrix is nnz-sharded over a device
mesh and partial y combined with one psum — the reference's
sblas_spmv_csr_v1 over managed memory (spmv_um.h:35-139).
SBLAS_HBM_BUDGET (bytes, default 256 MiB) caps resident HBM per device.
"""

from __future__ import annotations

import sys

from .common import finish, positional, setup_devices

USAGE = ("usage: python -m sblas.cli.spmv_test_um "
         "<A.mtx> <alpha> <beta> <n_devices> [tuning 0|1] [f32|f64]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, alpha, beta, n_dev = positional(
        argv, range(4), (str, float, float, int), USAGE)
    tuning = bool(int(argv[4])) if len(argv) > 4 else False
    dtype_name = argv[5] if len(argv) > 5 else "f32"

    from .common import ensure_dtype
    ensure_dtype(dtype_name)
    setup_devices(n_dev)

    import jax.numpy as jnp
    import numpy as np

    from ..containers import CsrMatrix, DenseVector
    from ..memory import host_resident_plan, spmv_um
    from ..ops.cpu_reference import spmv_cpu
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    np_dtype = np.float64 if dtype_name == "f64" else np.float32
    jnp_dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    times: dict = {}
    import os
    budget = int(os.environ.get("SBLAS_HBM_BUDGET", 256 << 20))

    with timed("Load time", times):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        x = DenseVector.random(A.width, dtype=np_dtype)
        y = DenseVector.constant(A.height, 1.0, dtype=np_dtype)
    if n_dev > 1:
        from ..memory import host_resident_shards, spmv_um_dist
        from ..parallel import make_mesh
        mesh = make_mesh(n_dev)
        with timed("Distribution time", times):
            hs = host_resident_shards(A, n_dev, dtype=jnp_dtype,
                                      hbm_budget_bytes=budget)
        run = lambda xd, yd: spmv_um_dist(  # noqa: E731
            hs, xd, alpha, beta, yd, mesh, tuning=tuning)
        n_bands, band_rows, kind = hs.n_bands, hs.band_rows, hs.kind
    else:
        with timed("Distribution time", times):
            hp = host_resident_plan(A, dtype=jnp_dtype,
                                    hbm_budget_bytes=budget)
        run = lambda xd, yd: spmv_um(  # noqa: E731
            hp, xd, alpha, beta, yd, tuning=tuning)
        n_bands, band_rows, kind = hp.n_bands, hp.band_rows, hp.kind
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, {n_dev} device(s), "
          f"{n_bands} band(s) x {band_rows} rows [{kind}], "
          f"tuning={int(tuning)}")

    from .common import steady_run_ms
    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    run(xd, yd)  # compile+warm
    # no device-side loop here: the streaming path is a host band loop and
    # really pays per-dispatch cost — the async-batch estimator keeps it
    ms, got, _ = steady_run_ms(lambda: run(xd, yd))
    times["Run time"] = ms
    print(f"nnz/s = {nnz_per_s(A.nnz, ms):.3e}")

    with timed("CPU run time", times):
        want = spmv_cpu(A, x, alpha, beta, y)
    report = check_equal(np.asarray(got), want,
                         relative=(np_dtype == np.float32))
    print(report)
    return finish(report.ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
