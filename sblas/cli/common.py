"""Shared CLI driver machinery.

The reference's five test binaries share a shape: parse positional argv,
load operands, run a distributed op, verify against the CPU oracle, print
Load/Run/CPU times and `Validation = True/False` (spmm_test.cu:19-56,
spmv_test.cu:9-42).  This module factors that shape once.

Deviations (documented): process exit code reflects validation (the
reference's unit_test returns 0 unconditionally, unit_test.cu:177-187);
requesting more devices than exist is a usage error (exit 2) unless
`SBLAS_FORCE_CPU_DEVICES=1` builds a virtual CPU mesh of that size — the
reference simply crashes on cudaSetDevice.
"""

from __future__ import annotations

import os
import sys


def ensure_dtype(dtype_name: str) -> None:
    """Flip jax_enable_x64 BEFORE any trace when f64 is requested: the
    reference's drivers verify in double (spmv_test.cu:36), and JAX
    silently canonicalizes float64 -> float32 otherwise."""
    if dtype_name == "f64":
        import jax
        jax.config.update("jax_enable_x64", True)


def setup_devices(n_requested: int):
    """Return (mesh, n).  Must run before any other jax use.  Exits with
    a usage error when fewer than `n_requested` devices are visible."""
    import jax

    from ..utils.compile_cache import enable_compile_cache
    if os.environ.get("SBLAS_FORCE_CPU_DEVICES") == "1":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(n_requested, 1))
    enable_compile_cache()
    from ..parallel import make_mesh

    avail = len(jax.devices())
    if n_requested > avail:
        print(f"[sblas] requested {n_requested} devices, have {avail} "
              f"({jax.devices()[0].platform}); set "
              f"SBLAS_FORCE_CPU_DEVICES=1 for a virtual CPU mesh",
              file=sys.stderr)
        raise SystemExit(2)
    return make_mesh(n_requested), n_requested


def finish(ok: bool, times_ms: dict) -> int:
    """Print the reference-style report; return a process exit code."""
    for name, ms in times_ms.items():
        print(f"{name} = {ms:.3f} ms")
    print(f"Validation = {ok}")
    return 0 if ok else 1


def positional(argv, names, casts, usage: str):
    if len(argv) < len(names):
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    return [cast(a) for a, cast in zip(argv, casts)]


def flag_value(rest, name: str, default, cast=str, usage: str = ""):
    """`--name VALUE` lookup with a usage error instead of an IndexError
    when the value is missing (a bare trailing flag previously died with
    a raw traceback)."""
    if name not in rest:
        return default
    i = rest.index(name)
    if i + 1 >= len(rest):
        print(usage or f"missing value for {name}", file=sys.stderr)
        raise SystemExit(2)
    return cast(rest[i + 1])


def steady_run_ms(run_once, run_coupled=None, operands=None,
                  estimator: str = "auto"):
    """Steady-state run time (ms), result, and the estimator used
    (`"wall" | "loop" | "amortized"`) for the driver report.

    A single timed call includes the host's dispatch and sync round trip,
    which dominates whenever the kernel is small, so:

    * one call clearly above 10x dispatch overhead -> report it;
    * else, when `run_coupled(eps, prev, operands)` is provided (the run
      with `eps` folded into its primary operand, `prev` — the previous
      output — as its accumulate operand, and the plan taken from
      `operands`) -> K device-side iterations inside ONE dispatch
      (utils.benchtime).  `operands` (the plan/shards pytree) is threaded
      through the loop as a jit ARGUMENT — closure capture would embed it
      in the program as constants;
    * else amortize: R back-to-back async dispatches, one true sync —
      per-call host dispatch stays in the number, which is honest for
      python-loop runs (UM streaming) that really pay it per call.

    Coupling shape matters: eps alone with a FIXED accumulate operand can
    compile a different (slower) loop, while 0.0-eps couplings fold away
    and let XLA hoist the body; eps + prev-as-accumulate keeps the loop
    honest.

    `estimator` pins the path ("wall"/"loop"/"amortized") so paired
    measurements (a full run and its nocomm twin for the comm/compute
    split) use the SAME estimator — mixing a wall-clock number (includes
    the dispatch) with a loop-derived one (excludes it) would let the
    difference absorb the estimator gap instead of the collective cost.
    """
    import time as _time

    from ..utils.benchtime import dispatch_overhead_ms, loop_time_ms
    from ..utils.timing import device_sync

    # warm OUTSIDE the timed window: the run may still miss the
    # compilation cache
    device_sync(run_once())

    t0 = _time.perf_counter()
    out = run_once()
    device_sync(out)
    t1 = (_time.perf_counter() - t0) * 1e3
    overhead = dispatch_overhead_ms()
    if estimator == "wall" or (estimator == "auto" and t1 >= 10 * overhead):
        return t1, out, "wall"
    if run_coupled is not None and estimator in ("auto", "loop"):
        def step(o, ops):
            import jax.numpy as jnp
            # tiny but NONZERO coupling: 0.0*carry constant-folds and XLA
            # hoists the whole loop body (measured: ash85 "ran" in 0 ms);
            # 1e-30*carry keeps a real data dependency, and the perturbed
            # loop values are discarded — only the timing matters
            return run_coupled(jnp.reshape(o, (-1,))[0] * 1e-30, o, ops)

        # escalate the device-side iteration count until the measured net
        # loop time clears the sync-noise floor (ash85-sized kernels run
        # in microseconds, far below one round trip)
        for iters in (64, 8192, 524288):
            ms = loop_time_ms(step, out, iters=iters, args=(operands,))
            if ms * iters >= overhead:
                break
        return ms, out, "loop"
    reps = 16
    t0 = _time.perf_counter()
    for _ in range(reps):
        out = run_once()
    device_sync(out)
    elapsed = (_time.perf_counter() - t0) * 1e3
    return max((elapsed - overhead) / reps, 1e-6), out, "amortized"
