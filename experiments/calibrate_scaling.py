#!/usr/bin/env python3
"""Calibrate the device data-movement prices of the xfoot planner.

`scaling.GATHER_NS` and `scaling.ROUTE_NS` price the xfoot extraction
engines (parallel/xfoot.py).  This script measures both at three sizes each on the device (two-point
estimator) and writes `scaling_calib.json` at the repo root, with the
device kind in its record; `scaling.py` loads it and reports the
constants' provenance.

* gather: out[i] = table[idx[i]] — XLA elementwise gather from a
  shard-scale table (256k entries, the x_ext regime xfoot prices),
  out sizes 256k / 1M / 4M;
* route: the routed permutation engine (ops/route.py) at padded route
  spaces 262144 / 2097152 / 8388608 (= 128^2*16, 128^3, 128^3*4 —
  spanning the radix-quantization cliffs).

    python experiments/calibrate_scaling.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "scaling_calib.json")


def _gather_step(y, table, idx):
    import jax.numpy as jnp
    return jnp.take(table + 1e-6 * y[0], idx)


def measure_gather(table_n: int = 262_144,
                   out_sizes=(262_144, 1_048_576, 4_194_304)) -> dict:
    import jax.numpy as jnp

    from sblas.utils.benchtime import loop_time2_ms

    rng = np.random.RandomState(7)
    table = jnp.asarray(rng.random_sample(table_n).astype(np.float32))
    out = {}
    for n in out_sizes:
        idx = jnp.asarray(rng.randint(0, table_n, size=n).astype(np.int32))
        y0 = jnp.zeros(n, jnp.float32)
        iters = max(min(int(40.0 / (n * 2.3e-6)), 2048), 64)
        ms = loop_time2_ms(_gather_step, y0, iters=iters,
                           args=(table, idx))
        out[n] = ms * 1e6 / n  # ns per gathered element
        print(f"# gather n={n}: {ms:.4f} ms = {out[n]:.3f} ns/elem",
              file=sys.stderr)
    return out


def measure_route(sizes=(262_144, 2_097_152, 8_388_608)) -> dict:
    import jax.numpy as jnp

    from sblas.ops.route import (apply_route, build_route,
                                     route_tables_device)
    from sblas.utils.benchtime import loop_time2_ms

    rng = np.random.RandomState(11)
    out = {}
    for n in sizes:
        t0 = time.perf_counter()
        prog = build_route(rng.permutation(n).astype(np.int32))
        sched = prog.schedule
        print(f"# route n={n}: plan {time.perf_counter() - t0:.1f} s, "
              f"{len(sched)} ops", file=sys.stderr)
        tables = route_tables_device(prog)
        x = jnp.asarray(rng.random_sample(n).astype(np.float32))
        y0 = jnp.zeros(n, jnp.float32)

        def step(y, x_, *tbls):
            return apply_route(sched, x_ + 1e-6 * y[0], tbls)

        iters = max(min(int(40.0 / (n * 0.09e-6)), 2048), 32)
        ms = loop_time2_ms(step, y0, iters=iters, args=(x, *tables))
        out[n] = ms * 1e6 / n  # ns per routed element (padded space)
        print(f"# route n={n}: {ms:.4f} ms = {out[n]:.3f} ns/elem",
              file=sys.stderr)
    return out


def main() -> int:
    import jax

    from sblas.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    gather = measure_gather()
    route = measure_route()
    calib = {
        "meta": {
            "device": str(dev),
            "device_kind": dev.device_kind,
            "platform": dev.platform,
            "date": time.strftime("%Y-%m-%d"),
            "method": "experiments/calibrate_scaling.py two-point "
                      "fori_loop timing",
        },
        "gather_ns": {str(k): round(v, 4) for k, v in gather.items()},
        "route_ns": {str(k): round(v, 4) for k, v in route.items()},
        # the model consumes one number per constant: the median across
        # sizes, with per-size values kept above so insensitivity (or
        # its absence) is auditable
        "gather_ns_median": round(float(np.median(list(gather.values()))),
                                  4),
        "route_ns_median": round(float(np.median(list(route.values()))),
                                 4),
    }
    with open(OUT, "w") as fh:
        json.dump(calib, fh, indent=1)
    print(json.dumps(calib))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
