#!/usr/bin/env python3
"""PageRank on the webbase proxy — the routed SpMV engine in its natural
habitat (power iteration over a web graph with hub columns).

    python examples/pagerank.py [--n 100000] [--damping 0.85] [--tol 1e-8]

Builds the column-stochastic transition matrix P^T from the webbase-like
proxy (out-degree-normalized, transposed so ranks update as r' = a*P^T r
+ (1-a)/n + dangling mass), plans it once (`make_plan(op="spmv")`), and
iterates until the L1 change passes `tol`.  Set SBLAS_FORCE_CPU_DEVICES=1
to run on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=200)
    args = ap.parse_args()

    if os.environ.get("SBLAS_FORCE_CPU_DEVICES") == "1":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    from sblas.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from sblas.containers import CooMatrix
    from sblas.io.generate import webbase_like
    from sblas.ops import make_plan, spmv

    t0 = time.time()
    G = webbase_like(n=args.n, avg_deg=3.1,
                     local_scale=min(2000.0, args.n / 50))
    n = G.shape[0]
    # P^T: edge (i -> j) contributes 1/outdeg(i) at (j, i)
    coo = G.to_coo()
    outdeg = np.maximum(G.row_nnz, 1).astype(np.float64)
    PT = CooMatrix(coo.col_idx, coo.row_idx,
                   (1.0 / outdeg[coo.row_idx]).astype(np.float32),
                   (n, n)).to_csr()
    dangling = jnp.asarray((G.row_nnz == 0).astype(np.float32))
    print(f"graph: {n} pages, {G.nnz} links (build {time.time() - t0:.1f}s)")

    t0 = time.time()
    plan = make_plan(PT, dtype=jnp.float32, op="spmv")
    print(f"plan: {type(plan).__name__} (build {time.time() - t0:.1f}s)")

    a = args.damping

    @jax.jit
    def step(r, plan_):
        spread = spmv(plan_, r, 1.0, 0.0, jnp.zeros_like(r))
        mass = jnp.vdot(dangling, r)  # dangling pages spread uniformly
        r_new = a * (spread + mass / n) + (1.0 - a) / n
        return r_new, jnp.abs(r_new - r).sum()

    r = jnp.full(n, 1.0 / n, jnp.float32)
    t0 = time.time()
    it, delta = 0, 1.0
    while it < args.maxiter and delta > args.tol:
        # NB: fetching the scalar every iteration costs a sync round trip;
        # the library path (sblas.solvers.pagerank) fuses the loop
        r, d = step(r, plan)
        it += 1
        delta = float(d)
    dt = time.time() - t0
    r_np = np.asarray(r)
    top = np.argsort(-r_np)[:5]
    print(f"PageRank: {it} iters in {dt:.2f}s "
          f"({it * G.nnz / dt / 1e6:.1f} Mnnz/s sustained), "
          f"L1 delta {delta:.2e}, sum {r_np.sum():.6f}")
    print("top pages:", ", ".join(f"{i} ({r_np[i]:.2e})" for i in top))
    ok = abs(float(r_np.sum()) - 1.0) < 1e-3 and delta <= args.tol
    print(f"Validation = {bool(ok)}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
