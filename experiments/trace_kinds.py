#!/usr/bin/env python3
"""Where the device time of one call goes, per plan kind.

For every kind that chip_smoke.py's phase c builds on the two reference
workloads (webbase-proxy SpMV, shell-proxy SpMM K=64), plus cuSPARSE CSR
through jax.experimental.sparse, run CALLS single calls back to back
(block_until_ready after each, as a Python caller does) under
jax.profiler, then read the trace: device busy time per call, the idle
share of the traced span, and the top device ops.  Two variant forms ride
along to size ROADMAP items: COO SpMV with the 1-D segment_sum's sorted
flag off ("coo_unsorted"), and windowed-COO SpMM with its slots sorted by
row at plan time so the scatter-add may assume sorted rows
("wcoo_sorted").  Every form is checked against the CPU oracle first.

    python experiments/trace_kinds.py [--calls 20] [--out DIR]

Traces are kept under DIR (default chiprun_out/trace_kinds, gitignored)
and can be re-read with experiments/trace_summary.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from trace_summary import summarize  # noqa: E402


def variant_forms(op: str, A):
    """{name: (plan, fn)} for the variant forms of one workload, fn
    taking (plan, X, alpha, beta, Y) like spmv/spmm."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from sblas.ops import make_plan

    if op == "spmv":
        @jax.jit
        def coo_unsorted(p, x, alpha, beta, y):
            contrib = p.vals * jnp.take(x, p.cols, axis=0)
            ax = jax.ops.segment_sum(contrib, p.rows,
                                     num_segments=p.shape[0],
                                     indices_are_sorted=False)
            return beta * y + alpha * ax
        return {"coo_unsorted": (make_plan(A, dtype=jnp.float32,
                                           force="coo"), coo_unsorted)}

    @jax.jit
    def wcoo_sorted(p, B, alpha, beta, C):
        gathered = jnp.take(B, p.cols, axis=0)
        ab = jax.ops.segment_sum(p.vals[:, None] * gathered, p.rows,
                                 num_segments=p.shape[0],
                                 indices_are_sorted=True)
        return beta * C + alpha * ab
    w = make_plan(A, dtype=jnp.float32, force="wcoo")
    order = jnp.asarray(np.argsort(np.asarray(w.rows), kind="stable"))
    ws = dataclasses.replace(w, cols=w.cols[order], rows=w.rows[order],
                             vals=w.vals[order])
    return {"wcoo_sorted": (ws, wcoo_sorted)}


def trace_one(name: str, fn, out_dir: str, calls: int) -> dict:
    """Trace `calls` blocking calls of fn() and summarize them per call."""
    import jax
    for _ in range(2):
        jax.block_until_ready(fn())
    path = os.path.join(out_dir, name)
    with jax.profiler.trace(path):
        for _ in range(calls):
            jax.block_until_ready(fn())
    s = summarize(path)
    return {
        "busy_us_per_call": s["device_busy_ms"] * 1e3 / calls,
        "span_us_per_call": s["wall_ms"] * 1e3 / calls,
        "idle_share": 1.0 - s["device_busy_frac"],
        "top_us_per_call": [(n, ms * 1e3 / calls)
                            for n, ms in s["top_device_ops"]],
        "device_threads": s["device_threads"],
    }


def trace_workload(op: str, A, X, Y, want, out_dir: str,
                   calls: int) -> dict:
    import jax.numpy as jnp

    from sblas.ops import make_plan, spmm, spmv
    run = spmv if op == "spmv" else spmm
    alpha, beta = 3.0, 4.0
    forms = {}
    for kind in cs.KINDS:
        if kind == "routed" and op != "spmv":
            continue
        if cs.plan_bytes(A, kind) > cs.PLAN_BYTES_CAP:
            continue
        forms[kind] = (make_plan(A, dtype=jnp.float32, force=kind, op=op),
                       run)
    forms.update(variant_forms(op, A))
    res = {}
    for name, (plan, fn) in forms.items():
        cs.check("trace", f"{op} {name}", fn(plan, X, alpha, beta, Y), want)
        res[name] = trace_one(f"{op}_{name}",
                              lambda: fn(plan, X, alpha, beta, Y),
                              out_dir, calls)
    csr = (jnp.asarray(A.values.astype(np.float32)),
           jnp.asarray(A.col_idx.astype(np.int32)),
           jnp.asarray(A.row_ptr.astype(np.int32)))
    f = cs.cusparse_fn(op, A.shape)
    cs.check("trace", f"{op} cusparse", f(*csr, X, alpha, beta, Y), want)
    res["cusparse"] = trace_one(f"{op}_cusparse",
                                lambda: f(*csr, X, alpha, beta, Y),
                                out_dir, calls)
    for name, r in res.items():
        top = ", ".join(f"{n} {us:.1f}" for n, us in r["top_us_per_call"][:4])
        cs.say("trace", f"{op} {name}: busy {r['busy_us_per_call']:.1f} "
               f"us/call, idle {r['idle_share'] * 100:.0f}% of the span; "
               f"top ops (us/call): {top}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(_ROOT, "chiprun_out",
                                                  "trace_kinds"))
    args = ap.parse_args(argv)
    cs.phase_device()
    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    from sblas.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    web = webbase_like(dtype=np.float32)
    x = DenseVector.random(web.width, dtype=np.float32)
    y = DenseVector.constant(web.height, 1.0, dtype=np.float32)
    res = {"spmv": trace_workload(
        "spmv", web, jnp.asarray(x.values), jnp.asarray(y.values),
        spmv_cpu(web, x, 3.0, 4.0, y), args.out, args.calls)}
    shell = fem_shell_like(dtype=np.float32)
    B = DenseMatrix.random(shell.width, cs.K, dtype=np.float32)
    C = DenseMatrix.constant(shell.height, cs.K, 1.0, dtype=np.float32)
    res["spmm"] = trace_workload(
        "spmm", shell, jnp.asarray(B.values), jnp.asarray(C.values),
        spmm_cpu(shell, B, 3.0, 4.0, C), args.out, args.calls)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
