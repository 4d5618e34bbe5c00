#!/usr/bin/env python3
"""Distributed PageRank over the footprint-compressed x-exchange mode.

    python examples/pagerank_dist.py [--n 100000] [--devices 8]
                                     [--damping 0.85] [--tol 1e-8]

The xfoot mode's contract is exactly a solver loop's steady state: the
rank vector stays row-block-sharded across devices, each iteration
exchanges only the column footprint (hot hub columns through one small
psum, single-demander columns through one all_to_all), and the updated
ranks come back in the SAME sharded layout — zero full-vector
collectives anywhere in the loop.  Compare the reference's distributed
SpMV, which all-reduces the complete result every call (spmv.h:115-118).

The damping/dangling/teleport epilogue needs two scalars (total dangling
mass, L1 delta) — each is one `jnp.vdot`-style reduction over the
sharded vectors, which XLA lowers to a scalar psum: bytes moved per
iteration stay O(footprint + 1), not O(n).

Runs anywhere: on the dev box set SBLAS_FORCE_CPU_DEVICES=1 (or run
under tests' virtual mesh) to get 8 virtual devices.
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
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=200)
    args = ap.parse_args()

    if os.environ.get("SBLAS_FORCE_CPU_DEVICES") == "1":
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(args.devices, 1))

    import jax

    from sblas.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # the example computes in f64 (tight tolerances on a probability
    # vector); without x64 JAX silently truncates to f32 and the printed
    # exchange bytes would overstate 2x
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from sblas.containers import CooMatrix
    from sblas.io.generate import webbase_like
    from sblas.parallel import make_mesh, partition_xfoot, spmv_xfoot
    from sblas.utils.timing import timed

    n_dev = min(args.devices, len(jax.devices()))
    mesh = make_mesh(n_dev)
    times: dict = {}

    with timed("build graph", times):
        A = webbase_like(n=args.n, dtype=np.float64)
        # column-stochastic P^T: transpose, normalize columns by
        # out-degree (rows of A), pattern-only weights
        coo = A.to_coo()
        out_deg = np.maximum(A.row_nnz, 1).astype(np.float64)
        vals = 1.0 / out_deg[coo.row_idx]
        Pt = CooMatrix(coo.col_idx, coo.row_idx, vals, A.shape).to_csr()
        dangling = (A.row_nnz == 0)

    with timed("partition (xfoot)", times):
        shards = partition_xfoot(Pt, n_dev, dtype=jnp.float64)
        st = shards.stats
        print(f"xfoot: kind={shards.kind}, hot {st.hot_total} cols, "
              f"packets {st.packet_pad}/pair, extract {st.extract_mode}, "
              f"exchange {st.comm_bytes(8) / 1e3:.1f} KB/chip/iter "
              f"(full vector would be {Pt.shape[0] * 8 / 1e3:.1f} KB)")

    n = Pt.shape[0]
    a = args.damping
    dang = jnp.asarray(dangling.astype(np.float64))
    r = jnp.full(n, 1.0 / n)

    with timed("power iteration", times):
        it = 0
        delta = jnp.asarray(float("inf"))
        converged = False
        for it in range(1, args.maxiter + 1):
            # dangling mass + teleport fold into a uniform term
            dm = jnp.vdot(dang, r)
            r_new = spmv_xfoot(shards, r, a, 0.0, jnp.zeros_like(r), mesh)
            r_new = r_new + (a * dm + (1.0 - a)) / n
            delta = jnp.sum(jnp.abs(r_new - r))
            r = r_new
            if float(delta) < args.tol:
                converged = True
                break

    r_host = np.asarray(r)
    top = np.argsort(-r_host)[:5]
    print(f"converged in {it} iterations on {n_dev} devices "
          f"(L1 delta {float(delta):.2e})")
    print("top ranks:", ", ".join(f"#{i}={r_host[i]:.3e}" for i in top))
    ok = abs(r_host.sum() - 1.0) < 1e-6 and converged
    print(f"sum(r) = {r_host.sum():.6f} (should be ~1)")
    for name, ms in times.items():
        print(f"{name} = {ms:.1f} ms")
    print(f"Validation = {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
