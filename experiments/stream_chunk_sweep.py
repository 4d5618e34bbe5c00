#!/usr/bin/env python3
"""SBLAS_STREAM_CHUNK sweep on the UM streaming paths (on the device).

`memory/host.py` dispatches one program per group of streamed bands;
grouping G bands per dispatch (`_stream_chunk`) divides the per-dispatch
host overhead by G.

Streaming is HOST-DISPATCH-bound, so the honest metric here is wall
clock across repeated full op calls (loop_time_ms's single-dispatch
fori_loop would hide exactly the overhead being measured).  Every
configuration is oracle-gated before timing.

Run on the GPU, fresh process, no env overrides:
    python experiments/stream_chunk_sweep.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import webbase_like
    from sblas.memory.host import host_resident_plan, spmm_um, spmv_um
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    from sblas.utils.verify import assert_equal

    print(f"# device {jax.devices()[0]}", file=sys.stderr)
    W = webbase_like(dtype=np.float32)
    budget = 16 << 20
    K = 16

    x = DenseVector.random(W.width, dtype=np.float32)
    y = DenseVector.constant(W.height, 1.0, dtype=np.float32)
    B = DenseMatrix.random(W.width, K, dtype=np.float32)
    C = DenseMatrix.constant(W.height, K, 1.0, dtype=np.float32)
    want_v = spmv_cpu(W, x, 1.0, 1.0, y)
    want_m = spmm_cpu(W, B, 1.0, 1.0, C)

    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)

    def wall_ms(fn, reps=5):
        fn()  # warm (compile every band program)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            np.asarray(jnp.sum(out))  # real sync
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.min(ts))

    for chunk in (1, 2, 4, 8):
        os.environ["SBLAS_STREAM_CHUNK"] = str(chunk)
        hplan = host_resident_plan(W, dtype=jnp.float32,
                                   hbm_budget_bytes=budget)
        out_v = spmv_um(hplan, xd, 1.0, 1.0, yd)
        assert_equal(np.asarray(out_v), want_v, relative=True)
        ms_v = wall_ms(lambda: spmv_um(hplan, xd, 1.0, 1.0, yd))
        out_m = spmm_um(hplan, Bd, 1.0, 1.0, Cd)
        assert_equal(np.asarray(out_m), want_m, relative=True)
        ms_m = wall_ms(lambda: spmm_um(hplan, Bd, 1.0, 1.0, Cd), reps=3)
        print(f"chunk={chunk}: bands={hplan.n_bands} "
              f"spmv_um {ms_v:8.1f} ms ({W.nnz / ms_v / 1e6:.3f} Gnnz/s)  "
              f"spmm_um {ms_m:8.1f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
