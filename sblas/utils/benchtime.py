"""Device-accurate kernel timing without the host's dispatch cost.

JAX dispatches asynchronously, and for sub-millisecond kernels the host's
per-call dispatch and sync dominate a wall-clock time of one call.
Strategy:

1. run K iterations of the op inside ONE jitted `lax.fori_loop` (single
   dispatch, K device-side executions);
2. thread the carry through the op's *inputs* (not just the epilogue) so
   XLA cannot hoist the loop-invariant hot computation out of the loop;
3. block until the result is ready, and amortize: per-iter =
   (t_loop(K) - t_dispatch) / K, or the two-point form below.

`loop_time_ms` is the framework's `gpu_timer` equivalent
(reference utility.h:163-178, cudaEvent pair).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _sync(x) -> None:
    """Wait for device completion of `x`."""
    jax.block_until_ready(x)


@partial(jax.jit, static_argnames=("step", "iters"))
def _looped(carry, step, iters: int, *args):
    return lax.fori_loop(0, iters, lambda i, c: step(c, *args), carry)


_OVERHEAD_MS = None


def dispatch_overhead_ms(n: int = 10) -> float:
    """Median cost of one null dispatch+sync round trip (measured once per
    process: it is a property of the host and device)."""
    global _OVERHEAD_MS
    if _OVERHEAD_MS is not None:
        return _OVERHEAD_MS
    f = jax.jit(lambda x: x + 1.0)
    x = jnp.zeros((8, 128), jnp.float32)
    _sync(f(x))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _sync(f(x))
        ts.append((time.perf_counter() - t0) * 1e3)
    _OVERHEAD_MS = float(np.median(ts))
    return _OVERHEAD_MS


def loop_time_ms(step, init_carry, iters: int = 32, reps: int = 5,
                 args: tuple = ()) -> float:
    """Median per-iteration device time of `step` (carry[, *args] -> carry).

    `step` must consume its carry in the hot path (see module docstring);
    it is hashed as a static jit argument, so pass a module-level function
    or a stable closure.  Pass LARGE operands (plans!) through `args`, not
    closure capture: captured arrays are embedded in the program as HLO
    constants."""
    overhead = dispatch_overhead_ms()
    _sync(_looped(init_carry, step, iters, *args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(_looped(init_carry, step, iters, *args))
        ts.append((time.perf_counter() - t0) * 1e3)
    # min over reps (each rep already averages `iters` device executions):
    # the standard low-noise estimator against host contention
    total = float(np.min(ts))
    return max(total - overhead, 1e-6) / iters


def loop_time2_ms(step, init_carry, iters: int = 2048, reps: int = 5,
                  args: tuple = ()) -> float:
    """Two-point variant of `loop_time_ms` for MICROSECOND-scale stages.

    per-iter = (min t(2K) - min t(K)) / K: the dispatch constant cancels
    per run instead of being subtracted as a separately-measured median,
    which matters when K*stage is comparable to the dispatch noise.
    Costs ~3x the loop executions."""
    _sync(_looped(init_carry, step, iters, *args))      # compile + warm K
    _sync(_looped(init_carry, step, 2 * iters, *args))  # compile + warm 2K
    t1s, t2s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(_looped(init_carry, step, iters, *args))
        t1s.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        _sync(_looped(init_carry, step, 2 * iters, *args))
        t2s.append((time.perf_counter() - t0) * 1e3)
    return max(float(np.min(t2s)) - float(np.min(t1s)), 1e-6) / iters
