"""SpMM driver — argv contract of the reference's spmm_test binary.

    python -m sblas.cli.spmm_test <method 1|2|2p|halo> <A.mtx>
                                      <B_width> <alpha> <beta> <n_devices>
                                      [dtype]

Mirrors spmm_test.cu:95-124: method 1 = partition dense B (no comm,
spmmCsrTest spmm_test.cu:19-56), method 2 = partition sparse A + sum
collective (spmmCsrTest2 spmm_test.cu:58-93).  Method 2p is mode 2 with
per-shard fast plans (parallel/planned.py; no reference analog); method
halo is the row-block + ppermute B-exchange SpMM over per-shard DIA
plans (square A; the banded scaling mode — constant comm in n where
mode 2 all-reduces the full C).  Every run verifies against the CPU
oracle and prints Load/Run/CPU times.
"""

from __future__ import annotations

import sys

from .common import finish, positional, setup_devices

USAGE = ("usage: python -m sblas.cli.spmm_test "
         "<method 1|2|2p|halo> <A.mtx> <B_width> <alpha> <beta> "
         "<n_devices> [f32|f64]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    method, path, b_width, alpha, beta, n_dev = positional(
        argv, range(6), (str, str, int, float, float, int), USAGE)
    dtype_name = argv[6] if len(argv) > 6 else "f32"

    from .common import ensure_dtype
    ensure_dtype(dtype_name)
    mesh, n = setup_devices(n_dev)

    import jax.numpy as jnp
    import numpy as np

    from ..containers import CsrMatrix, DenseMatrix, MajorOrder
    from ..ops import make_plan
    from ..ops.cpu_reference import spmm_cpu
    from ..parallel import (partition_halo_dia, partition_row_plans,
                            spmm_halo_planned, spmm_mode1, spmm_mode2,
                            spmm_mode2_planned, sync_to_host)
    from ..partition import partition_nnz_balanced, partition_report
    from ..utils.timing import gflops, spmm_flops, timed
    from ..utils.verify import check_equal

    np_dtype = np.float64 if dtype_name == "f64" else np.float32
    jnp_dtype = jnp.float64 if dtype_name == "f64" else jnp.float32
    times: dict = {}

    with timed("Load time", times):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        # reference: B random col-major, C fill 1.0 (spmm_test.cu:24-26)
        B = DenseMatrix.random(A.width, b_width, order=MajorOrder.COL_MAJOR,
                               dtype=np_dtype)
        C = DenseMatrix.constant(A.height, b_width, 1.0, dtype=np_dtype)
        if method == "1":
            plan = make_plan(A, dtype=jnp_dtype)
        elif method == "2p":
            shards = partition_row_plans(A, n, dtype=jnp_dtype)
            print(f"per-shard plans: kind={shards.kind}, "
                  f"band_rows={shards.band_rows}")
        elif method == "halo":
            hshards = partition_halo_dia(A, n, dtype=jnp_dtype)
            print(f"halo DIA shards: {len(hshards.plan.offsets)} "
                  f"diagonals, block {hshards.rows_per_shard}")
        else:
            segs = partition_nnz_balanced(A, n, dtype=jnp_dtype)
            print(partition_report(segs))
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, K={b_width}, "
          f"{n} device(s), method {method}")

    from .common import steady_run_ms
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)
    run = {
        "1": lambda: spmm_mode1(plan, Bd, alpha, beta, Cd, mesh),
        "2": lambda: spmm_mode2(segs, Bd, alpha, beta, Cd, mesh),
        "2p": lambda: spmm_mode2_planned(shards, Bd, alpha, beta, Cd, mesh),
        "halo": lambda: spmm_halo_planned(hshards, Bd, alpha, beta, Cd,
                                          mesh),
    }[method]
    run_c = {
        "1": lambda e, o, pl: spmm_mode1(pl, Bd + e, alpha, beta, o, mesh),
        "2": lambda e, o, sg: spmm_mode2(sg, Bd + e, alpha, beta, o, mesh),
        "2p": lambda e, o, sh: spmm_mode2_planned(sh, Bd + e, alpha, beta,
                                                  o, mesh),
        "halo": lambda e, o, hs: spmm_halo_planned(hs, Bd + e, alpha,
                                                   beta, o, mesh),
    }[method]
    operands = {"1": lambda: plan, "2": lambda: segs,
                "2p": lambda: shards, "halo": lambda: hshards}[method]()
    run()  # compile + first run (the reference times a cold run; we
    # report the steady-state run, plus GFLOPs the reference omits)
    ms, got, est = steady_run_ms(run, run_c, operands)
    times[f"{n}-device run time"] = ms
    print(f"GFLOPS = {gflops(spmm_flops(A.nnz, b_width), ms):.3f}")

    # comm/compute phase split (reference prints per-GPU NCCL all-reduce
    # time, spmm.h:258-271): time the same per-shard compute without the
    # collective and subtract.  XLA may overlap comm with compute, so this
    # is the *exposed* collective cost.
    if method in ("2", "2p") and n > 1:
        from ..parallel import spmm_mode2_nocomm, spmm_mode2_planned_nocomm
        nc = (lambda: spmm_mode2_nocomm(segs, Bd, mesh)) if method == "2" \
            else (lambda: spmm_mode2_planned_nocomm(shards, Bd, mesh))
        nc_c = (lambda e, o, sg: spmm_mode2_nocomm(sg, Bd + e, mesh)) \
            if method == "2" \
            else (lambda e, o, sh: spmm_mode2_planned_nocomm(sh, Bd + e,
                                                             mesh))
        nc()  # compile
        # same estimator as the full run (see spmv_test; ADVICE r2 #1)
        ms_nc, _, _ = steady_run_ms(nc, nc_c, operands, estimator=est)
        times["Comm time (exposed psum)"] = max(ms - ms_nc, 0.0)
        times["Compute time (per-shard)"] = ms_nc

    with timed("CPU run time", times):
        want = spmm_cpu(A, B, alpha, beta, C)

    report = check_equal(sync_to_host(got), want,
                         relative=(np_dtype == np.float32))
    print(report)
    return finish(report.ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
