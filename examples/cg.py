#!/usr/bin/env python3
"""Conjugate-gradient solve on the FEM shell proxy — the framework in a
real iterative loop (the production shape of SpMV: a NEW x every
iteration, exactly what the plans are built-once/run-many for).

    python examples/cg.py [--n 20000] [--dist N] [--tol 1e-6] [--f64]

Builds a symmetric positive-definite system from the s3dkq4m2-structure
proxy (symmetric stiffness pattern + diagonal dominance shift), plans it
once with `make_plan(op="spmv")`, and runs CG with the whole iteration
body jitted.  `--dist N` runs the same solve with the matrix nnz-sharded
over an N-device mesh (`partition_row_plans` + `spmv_dist_planned`) —
set SBLAS_FORCE_CPU_DEVICES=1 to use a virtual CPU mesh.

This script keeps a HOST-side loop (progress prints); the library path is
`sblas.solvers.cg`, which fuses the whole solve into one
`lax.while_loop` dispatch.

No reference analog: S-BLAS ships kernels only; this shows them composed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_spd(n: int, dtype):
    """Shell-proxy pattern, symmetrized values, diagonally dominant."""
    import numpy as np

    from sblas.containers import CooMatrix
    from sblas.io.generate import fem_shell_like

    nx = max(int(round((n / 6) ** 0.5 * (201 / 75) ** 0.5)), 4)
    ny = max(n // (6 * nx), 2)
    A = fem_shell_like(nx=nx, ny=ny, dof=6, n_target=nx * ny * 6,
                       dtype=np.float64)
    coo = A.to_coo()
    # diagonal dominance: d_i = 1 + sum_j |a_ij|
    rowsum = np.zeros(A.shape[0])
    np.add.at(rowsum, coo.row_idx, np.abs(coo.values))
    diag_rows = np.arange(A.shape[0])
    rows = np.concatenate([coo.row_idx, diag_rows])
    cols = np.concatenate([coo.col_idx, diag_rows])
    vals = np.concatenate([coo.values, 1.0 + rowsum]).astype(dtype)
    return CooMatrix(rows, cols, vals, A.shape).to_csr()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dist", type=int, default=0, metavar="N_DEV")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    if os.environ.get("SBLAS_FORCE_CPU_DEVICES") == "1":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(args.dist, 1))
    import jax

    from sblas.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    if args.f64:
        jax.config.update("jax_enable_x64", True)
    dtype = np.float64 if args.f64 else np.float32
    jdt = jnp.float64 if args.f64 else jnp.float32

    t0 = time.time()
    A = build_spd(args.n, dtype)
    print(f"SPD system: {A.shape[0]} unknowns, nnz {A.nnz} "
          f"(build {time.time() - t0:.1f}s)")

    rng = np.random.RandomState(7)
    x_true = rng.standard_normal(A.shape[0]).astype(dtype)

    if args.dist:
        from sblas.parallel import (make_mesh, partition_row_plans,
                                        spmv_dist_planned)
        mesh = make_mesh(args.dist)
        shards = partition_row_plans(A, mesh.shape["shards"], dtype=jdt)
        print(f"distributed over {mesh.shape['shards']} device(s), "
              f"kind={shards.kind}")

        def matvec(v):
            return spmv_dist_planned(shards, v, 1.0, 0.0,
                                     jnp.zeros_like(v), mesh)
    else:
        from sblas.ops import make_plan, spmv
        t0 = time.time()
        plan = make_plan(A, dtype=jdt, op="spmv")
        print(f"plan: {type(plan).__name__} (build {time.time() - t0:.1f}s)")

        def matvec(v):
            return spmv(plan, v, 1.0, 0.0, jnp.zeros_like(v))

    b = matvec(jnp.asarray(x_true))

    def cg_step(state):
        x, r, p, rs = state
        Ap = matvec(p)
        alpha = rs / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new

    cg_step_j = jax.jit(cg_step)
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.vdot(r, r)
    state = (x, r, p, rs)
    b2 = float(jnp.vdot(b, b))
    t0 = time.time()
    it = 0
    while it < args.maxiter:
        state = cg_step_j(state)
        it += 1
        if it % 10 == 0 or it == 1:
            res = float(state[3]) / b2
            if res < args.tol ** 2:
                break
    jax.block_until_ready(state)
    dt = time.time() - t0
    x = np.asarray(state[0])
    rel_err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    rel_res = (float(state[3]) / b2) ** 0.5
    print(f"CG: {it} iters in {dt:.2f}s "
          f"({it * A.nnz * 2 / dt / 1e9:.2f} GFLOP/s sustained SpMV), "
          f"rel residual {rel_res:.2e}, rel error vs x_true {rel_err:.2e}")
    ok = rel_res < max(args.tol, 1e-5) * 10
    print(f"Validation = {bool(ok)}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
