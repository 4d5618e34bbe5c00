#!/usr/bin/env python3
"""Profiling harness — the reference's profiling.sh rebuilt on jax.profiler.

The reference runs `nsys profile --trace=cuda,nvtx` with UM page-fault
counters over {SpMM mode 2, SpMV} x {tuning off, on} (profiling.sh:3-21).
The equivalents here:

* nsys trace            -> jax.profiler.trace (XPlane/Perfetto, view in
                           XProf/TensorBoard or ui.perfetto.dev)
* NVTX ranges           -> jax.profiler.TraceAnnotation via
                           sblas.utils.timing.trace_scope
* UM page-fault counts  -> host<->HBM DMA activity, visible as transfer ops
                           on the trace timeline

    python profiling.py [outdir] [--small]

Produces four traces: spmm_um_tuning{0,1}, spmv_um_tuning{0,1}, each over
the synthesized s3dkq4m2/webbase-class workloads (profiling.sh:6,16).
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main() -> int:
    args = sys.argv[1:]
    small = "--small" in args
    args = [a for a in args if a != "--small"]
    outdir = args[0] if args else "traces"
    os.makedirs(outdir, exist_ok=True)

    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.memory import host_resident_plan, spmm_um, spmv_um
    from sblas.utils.timing import trace_scope

    # the reference profiles spmm_test_um on s3dkq4m2 and spmv_test_um on
    # webbase-1M (profiling.sh:6,16) — same split here, over the proxies
    A = (fem_shell_like(nx=51, ny=25, dof=6, n_target=51 * 25 * 6 - 1,
                        dtype=np.float32)
         if small else fem_shell_like(dtype=np.float32))
    W = webbase_like(n=50_000 if small else 1_000_000, dtype=np.float32)
    hp = host_resident_plan(A, dtype=jnp.float32,
                            hbm_budget_bytes=32 << 20)
    hpw = host_resident_plan(W, dtype=jnp.float32,
                             hbm_budget_bytes=16 << 20)
    B = jnp.asarray(DenseMatrix.random(A.width, 64, dtype=np.float32).values)
    C = jnp.asarray(
        DenseMatrix.constant(A.height, 64, 1.0, dtype=np.float32).values)
    x = jnp.asarray(DenseVector.random(W.width, dtype=np.float32).values)
    y = jnp.asarray(
        DenseVector.constant(W.height, 1.0, dtype=np.float32).values)
    print(f"spmm workload: {A.shape} nnz={A.nnz}, {hp.n_bands} bands "
          f"[{hp.kind}]; spmv workload: {W.shape} nnz={W.nnz}, "
          f"{hpw.n_bands} bands [{hpw.kind}]", file=sys.stderr)

    runs = {
        "spmm_um_tuning0": lambda: spmm_um(hp, B, 1.0, 1.0, C, tuning=False),
        "spmm_um_tuning1": lambda: spmm_um(hp, B, 1.0, 1.0, C, tuning=True),
        "spmv_um_tuning0": lambda: spmv_um(hpw, x, 1.0, 1.0, y,
                                           tuning=False),
        "spmv_um_tuning1": lambda: spmv_um(hpw, x, 1.0, 1.0, y, tuning=True),
    }
    for name, fn in runs.items():
        hp.remove_gpu_tuning()
        hpw.remove_gpu_tuning()
        jax.block_until_ready(fn())  # compile outside the trace
        hp.remove_gpu_tuning()
        hpw.remove_gpu_tuning()
        trace_dir = os.path.join(outdir, name)
        with jax.profiler.trace(trace_dir):
            with trace_scope(name):
                jax.block_until_ready(fn())
        print(f"{name}: trace written to {trace_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
