"""Phase timing and throughput reporting.

Equivalents of the reference's timers:
* `cpu_timer` (gettimeofday, utility.h:142-160) -> `PhaseTimer` with
  perf_counter;
* `gpu_timer` (cudaEvent pair, utility.h:163-178) -> the same timer made
  device-accurate by calling `jax.block_until_ready` on the watched values
  (JAX dispatch is async exactly like CUDA streams);
* NVTX ranges (matrix_um.h:435-445 etc.) -> `jax.named_scope`/`jax.profiler`
  annotations via `trace_scope`.

Adds GFLOPs / nnz-per-second reporting, which the reference leaves to the
user (it prints raw ms only, spmm_test.cu:51-54).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import jax


def device_sync(*values) -> None:
    """Wait for device completion of every array in `values`."""
    jax.block_until_ready(values)


@dataclasses.dataclass
class PhaseTimer:
    """Accumulating millisecond timer (reference cpu_timer/gpu_timer)."""

    name: str = ""
    elapsed_ms: float = 0.0
    _t0: Optional[float] = None

    def start_timer(self) -> None:
        self._t0 = time.perf_counter()

    def stop_timer(self, *sync_values) -> float:
        """Stop; pass device values to block on for gpu_timer semantics."""
        device_sync(*sync_values)
        assert self._t0 is not None, "stop_timer before start_timer"
        self.elapsed_ms += (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return self.elapsed_ms

    def measure(self) -> float:
        return self.elapsed_ms


@contextlib.contextmanager
def timed(name: str, results: Optional[Dict[str, float]] = None,
          sync: Any = None):
    """Context-manager phase timer; stores ms under `name` in `results`."""
    t = PhaseTimer(name)
    t.start_timer()
    try:
        yield t
    finally:
        if sync is not None:
            device_sync(sync)
        t.stop_timer()
        if results is not None:
            results[name] = t.elapsed_ms


@contextlib.contextmanager
def trace_scope(name: str):
    """Named profiler annotation (NVTX-range analog) visible in XProf."""
    with jax.named_scope(name), jax.profiler.TraceAnnotation(name):
        yield


def spmv_flops(nnz: int) -> int:
    """FLOPs of y=beta*y+alpha*A@x: 2 per nnz (mul+add); alpha/beta fold is
    O(m) and ignored, matching common SpMV accounting."""
    return 2 * nnz


def spmm_flops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def gflops(flops: int, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")


def nnz_per_s(nnz: int, ms: float) -> float:
    return nnz / (ms * 1e-3) if ms > 0 else float("inf")
