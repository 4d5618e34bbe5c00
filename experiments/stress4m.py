#!/usr/bin/env python3
"""Scale stress on the device: 4M-row / 12.1M-nnz webbase-class routed
SpMV, plus the cached-plan reload time.  A stress, not a bench cell.

Run on the GPU, fresh process, no env overrides:
    python experiments/stress4m.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CACHE = os.path.join(".bench_cache", "webbase4m_full_routed_f32_v1.npz")


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sblas.io.generate import webbase_like
    from sblas.io.plancache import cached_plan
    from sblas.ops.rspmv import RoutedPlan, spmv_routed
    from sblas.utils.benchtime import loop_time_ms

    print(f"# device {jax.devices()[0]}", file=sys.stderr)
    t0 = time.time()
    W = webbase_like(n=4_000_000, dtype=np.float32)
    print(f"gen {time.time() - t0:.1f}s nnz={W.nnz}")

    t0 = time.time()
    plan = cached_plan(
        CACHE, lambda: RoutedPlan.from_csr(W, dtype=jnp.float32),
        valid=lambda p: p.shape == W.shape and p.nnz == W.nnz)
    print(f"plan ready {time.time() - t0:.1f}s (cached reload incl. "
          f"device upload when the cache hit)")
    print(f"route_n {plan.route_n} T_g {plan.n_gtiles} S {plan.n_srows}")

    # oracle on a deterministic slice: full spmv_cpu at 12M nnz costs
    # minutes of single-core host time; verify y[:64] against a direct
    # numpy computation over those rows instead
    x = np.random.RandomState(3).random_sample(W.shape[1]).astype(np.float32)
    xd = jnp.asarray(x)
    yd = jnp.zeros(W.shape[0], jnp.float32)
    got = np.asarray(spmv_routed(plan, xd, 1.0, 0.0, yd))
    lo, hi = int(W.row_ptr[0]), int(W.row_ptr[64])
    want64 = np.zeros(64)
    rows = np.repeat(np.arange(64), np.diff(W.row_ptr[:65]).astype(int))
    np.add.at(want64, rows,
              (W.values[lo:hi] * x[W.col_idx[lo:hi]]).astype(np.float64))
    err = np.abs(got[:64] - want64) / np.maximum(1.0, np.abs(want64))
    print(f"oracle[0:64] max_rel {err.max():.2e}")
    assert err.max() < 1e-3, "stress oracle failed"

    def step(yc, p):
        return spmv_routed(p, xd + 1e-6 * yc[:1], 1.0, 1.0, yc)

    ms = loop_time_ms(step, yd, args=(plan,))
    print(f"4M routed SpMV: {ms:.3f} ms = {W.nnz / ms * 1e-6:.3f} Gnnz/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
