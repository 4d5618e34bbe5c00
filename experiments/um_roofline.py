#!/usr/bin/env python3
"""UM streaming roofline.

Gives the `spmv_um`/`spmm_um` wall numbers a speed-of-light denominator —
the reference measures the same thing on the CUDA side as UM page-fault
counts under nsys (profiling.sh:3-21).  Three measurements on the device:

1. **pure DMA**: host(pinned)->HBM bandwidth at three transfer sizes,
   two-point over batch count so the per-dispatch constant cancels;
2. **achieved streaming**: the UM executors' wall per untuned call at the
   measured SBLAS_STREAM_CHUNK default and the bytes each call streams
   -> achieved GB/s;
3. **efficiency** = achieved / pure DMA at the matching transfer size;
   a trace summary (experiments/trace_summary.py over profiling.py's
   traces) independently decomposes the same wall into device-busy vs
   transfer-dispatch time.

    python experiments/um_roofline.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _tree_bytes(tree) -> int:
    import jax
    return sum(x.nbytes for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, "nbytes"))


import functools


@functools.lru_cache(maxsize=None)
def _reducer(k: int):
    """One cached jitted k-ary reducer (a fresh lambda per call would
    re-trace and re-compile every time)."""
    import jax
    import jax.numpy as jnp
    return jax.jit(lambda *xs: sum(jnp.sum(x) for x in xs))


def _fetch_sync(arrs) -> None:
    """Force device completion of everything queued before `arrs` were
    produced: a host fetch of a data-dependent scalar, which waits for
    the transfers themselves, not only for the arrays' handles.  DEVICE
    arrays only (a pinned-host input makes the AOT compiler reject the
    program's output layout)."""
    arrs = list(arrs)
    np.asarray(_reducer(len(arrs))(*arrs))


def measure_dma(sizes_mb=(8, 32, 128), k: int = 4) -> dict:
    """Pinned-host -> HBM copy bandwidth, two-point over batch count (the
    trailing reducer dispatch and its fetch cancel)."""
    import jax

    from sblas.memory.host import _to_device, _to_host

    out = {}
    for mb in sizes_mb:
        n = mb * (1 << 20) // 4
        # distinct source buffers so no transfer is elided by aliasing;
        # built from NUMPY so filling them never touches the device queue
        srcs = [_to_host(np.arange(i, i + n, dtype=np.float32))
                for i in range(2 * k)]
        jax.block_until_ready(srcs)  # host->host puts: no device async

        def put_batch(bufs):
            t0 = time.perf_counter()
            _fetch_sync([_to_device(b) for b in bufs])
            return time.perf_counter() - t0

        put_batch(srcs[:k])   # warm + compile the k-ary reducer
        put_batch(srcs)       # compile the 2k-ary reducer
        t_k = min(put_batch(srcs[:k]) for _ in range(3))
        t_2k = min(put_batch(srcs) for _ in range(3))
        bw = (k * mb / 1024) / max(t_2k - t_k, 1e-9)  # GiB/s
        out[mb] = bw
        print(f"# dma {mb} MiB x{k}: {bw:.2f} GiB/s "
              f"(t{k}={t_k*1e3:.1f} ms, t{2*k}={t_2k*1e3:.1f} ms)",
              file=sys.stderr)
    return out


def measure_um(op_name: str, fn, n1: int = 4) -> float:
    """Wall per call, two-point over call count (host-driven multi-
    dispatch executors cannot ride a fori_loop).  The device queue is
    serial, so one trailing fetch drains all n calls."""
    _fetch_sync([fn()])  # compile + warm

    def calls(n):
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        _fetch_sync([r])
        return time.perf_counter() - t0

    t1 = min(calls(n1) for _ in range(3))
    t2 = min(calls(2 * n1) for _ in range(3))
    ms = (t2 - t1) / n1 * 1e3
    print(f"# {op_name}: {ms:.1f} ms/call", file=sys.stderr)
    return ms


def main() -> int:
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.memory import host_resident_plan, spmm_um, spmv_um

    dma = measure_dma()
    best_dma = max(dma.values())

    A = fem_shell_like(dtype=np.float32)
    W = webbase_like(dtype=np.float32)
    hp = host_resident_plan(A, dtype=jnp.float32, hbm_budget_bytes=32 << 20)
    hpw = host_resident_plan(W, dtype=jnp.float32, hbm_budget_bytes=16 << 20)
    B = jnp.asarray(DenseMatrix.random(A.width, 64, dtype=np.float32).values)
    C = jnp.asarray(
        DenseMatrix.constant(A.height, 64, 1.0, dtype=np.float32).values)
    x = jnp.asarray(DenseVector.random(W.width, dtype=np.float32).values)
    y = jnp.asarray(
        DenseVector.constant(W.height, 1.0, dtype=np.float32).values)

    for name, plan, fn in (
            ("spmm_um", hp, lambda: spmm_um(hp, B, 1.0, 1.0, C,
                                            tuning=False)),
            ("spmv_um", hpw, lambda: spmv_um(hpw, x, 1.0, 1.0, y,
                                             tuning=False))):
        streamed = sum(_tree_bytes(b) for b in plan.bands)
        ms = measure_um(f"{name} untuned ({plan.n_bands} bands "
                        f"[{plan.kind}], {streamed / (1 << 20):.1f} MiB "
                        f"streamed/call)", fn)
        ach = streamed / (1 << 30) / (ms / 1e3)
        band_mb = streamed / plan.n_bands / (1 << 20)
        # pure-DMA bandwidth at the nearest measured transfer size
        near = min(dma, key=lambda s: abs(s - band_mb))
        print(f"# {name}: achieved {ach:.2f} GiB/s = "
              f"{ach / dma[near] * 100:.0f}% of pure DMA at ~band size "
              f"({dma[near]:.2f} GiB/s @ {near} MiB), "
              f"{ach / best_dma * 100:.0f}% of peak DMA", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
