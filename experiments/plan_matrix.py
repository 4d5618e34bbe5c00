#!/usr/bin/env python3
"""Plan-selection robustness matrix.

`make_plan`'s auto-selection heuristics (ops/__init__.py) were tuned on the
two reference benchmark classes (banded FEM shell, power-law web).  This
experiment measures on the device EVERY feasible forced layout against the auto
choice across ~10 synthetic structure classes x {SpMV, SpMM K=64}, so the
claim "auto is within 1.15x of the best forced plan" holds (or the
heuristic gets fixed) beyond the classes it was tuned on.  The reference
delegates this entirely to cuSPARSE's format-agnostic dispatch
(spmm.h:146-149); here the selection logic is ours, so it
needs its own evidence.

Auto is recorded as a CHOICE (which kind make_plan picked) and priced at
that kind's forced timing — make_plan(force=k) and the auto path build
identical plans, so timing auto separately would only double device time.

Resumable: rows append to `plan_matrix_results.jsonl` keyed by
(class, op, kind); completed keys are skipped on re-run.  `--report`
renders PLAN_MATRIX.md from the JSONL without touching the device.

    python experiments/plan_matrix.py [--classes a,b] [--report]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

RESULTS = os.path.join(os.path.dirname(__file__), "..",
                       "plan_matrix_results.jsonl")
REPORT = os.path.join(os.path.dirname(__file__), "..", "PLAN_MATRIX.md")
K = 64  # reference SpMM B width (spmm_test.cu argv, README.md:76)
TARGET = 1.15  # auto must be within this factor of the best forced plan

# device-memory guard for forced layouts whose padding explodes on hostile
# structure (DIA on uniform random would want ~80 GB of diagonals)
_BYTES_LIMIT = 2 << 30


def matrix_classes():
    from sblas.io.generate import (adversarial_skew, block_dominant,
                                       fem_banded_like, fem_shell_like,
                                       pattern_symmetric, road_network_like,
                                       scattered_sparse, uniform_random,
                                       webbase_like)
    f32 = np.float32
    return {
        # the two tuned-on classes, at reduced scale (controls)
        "shell_fem": lambda: fem_shell_like(nx=101, ny=50, dof=6,
                                            n_target=30_300, dtype=f32),
        "web_power": lambda: webbase_like(n=200_000, dtype=f32),
        # further structure classes
        "dense_band": lambda: fem_banded_like(n=30_000, half_band=36,
                                              dtype=f32),
        "block_dom": lambda: block_dominant(dtype=f32),
        "road_local": lambda: road_network_like(dtype=f32),
        "uniform": lambda: uniform_random(100_000, 100_000, 8, dtype=f32),
        "rect_wide": lambda: uniform_random(20_000, 200_000, 16, dtype=f32),
        "near_empty": lambda: scattered_sparse(dtype=f32),
        "skew_rows": lambda: adversarial_skew(m=65_536, n=65_536,
                                              heavy_rows=8, heavy_nnz=32_768,
                                              light_nnz=2, dtype=f32),
        "small_sym": lambda: pattern_symmetric(),
    }


def _feasible(kind: str, A, op: str) -> str | None:
    """None when the forced layout is buildable at sane memory, else the
    skip reason (recorded in the JSONL so skips are auditable)."""
    from sblas.ops import bell_stats, dia_stats
    m = A.shape[0]
    if kind == "routed":
        if op != "spmv":
            return "routed is SpMV-only"
        if A.nnz < 4096:
            return "routed: degenerate below a single gather tile"
        return None
    if kind == "dia":
        st = dia_stats(A)
        if st["n_diags"] * m * 4 > _BYTES_LIMIT:
            return (f"dia: {st['n_diags']} diags x {m} rows "
                    f"> {_BYTES_LIMIT >> 30} GiB")
        if st["n_diags"] > 16384:
            return f"dia: {st['n_diags']} diags (trace-time unroll)"
        return None
    if kind == "ell":
        max_deg = int(A.row_nnz.max()) if m else 0
        if max_deg * m * 8 > _BYTES_LIMIT:
            return f"ell: {max_deg} max-deg x {m} rows padding"
        return None
    if kind == "bsr":
        st = bell_stats(A)
        if st["blowup"] * max(A.nnz, 1) * 4 > _BYTES_LIMIT:
            return f"bsr: blowup {st['blowup']:.0f} over {A.nnz} nnz"
        return None
    return None  # coo / wcoo build at O(nnz)


def _kind_of(plan) -> str:
    from sblas.ops import (BsrPlan, CooPlan, DiaPlan, EllPlan,
                               RoutedPlan, WcooPlan)
    return {DiaPlan: "dia", RoutedPlan: "routed", BsrPlan: "bsr",
            EllPlan: "ell", WcooPlan: "wcoo", CooPlan: "coo"}[type(plan)]


def _mv_step(y, plan, x):
    from sblas.ops import spmv
    return spmv(plan, x + 1e-6 * y[0], 1.0, 1.0, y)


def _mm_step(C, plan, B):
    from sblas.ops import spmm
    return spmm(plan, B + 1e-6 * C[:1].mean(), 1.0, 1.0, C)


def _time_entry(step, carry, args) -> float:
    """Adaptive timing: a 16-iter one-point estimate sizes the loop, then
    sub-2ms kernels get the two-point estimator (CLAUDE.md: one-point
    spreads microsecond kernels by the +-5 ms dispatch constant).  iters
    quantize to powers of 4 so the estimate pass's compiled program is
    reused when the choice lands back on 16."""
    from sblas.utils.benchtime import loop_time2_ms, loop_time_ms
    est = loop_time_ms(step, carry, iters=16, reps=3, args=args)
    if est >= 2.0:
        return est
    iters = 64
    while iters * est < 40.0 and iters < 4096:
        iters *= 4
    return loop_time2_ms(step, carry, iters=iters, reps=3, args=args)


def run(only=None) -> int:
    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.plancache import cached_plan
    from sblas.ops import make_plan, spmm, spmv
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    from sblas.utils.verify import assert_equal

    done = set()
    if os.path.exists(RESULTS):
        with open(RESULTS) as fh:
            for line in fh:
                r = json.loads(line)
                done.add((r["class"], r["op"], r["kind"]))

    def emit(row):
        with open(RESULTS, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(f"# {row}", file=sys.stderr)

    kinds = ["dia", "routed", "bsr", "ell", "wcoo", "coo"]
    for cname, gen in matrix_classes().items():
        if only and cname not in only:
            continue
        todo = [(op, k) for op in ("spmv", "spmm") for k in kinds + ["auto"]
                if (cname, op, k) not in done]
        if not todo:
            continue
        A = gen()
        m, n = A.shape
        x = jnp.asarray(
            DenseVector.random(n, dtype=np.float32).values)
        y0 = jnp.asarray(
            DenseVector.constant(m, 1.0, dtype=np.float32).values)
        B = jnp.asarray(DenseMatrix.random(n, K, dtype=np.float32).values)
        C0 = jnp.asarray(
            DenseMatrix.constant(m, K, 1.0, dtype=np.float32).values)
        want_mv = want_mm = None
        for op, kind in todo:
            base = {"class": cname, "op": op, "kind": kind,
                    "shape": [m, n], "nnz": int(A.nnz),
                    "device_kind": jax.devices()[0].device_kind}
            if kind == "auto":
                plan = make_plan(A, dtype=jnp.float32, op=op)
                emit({**base, "choice": _kind_of(plan), "status": "ok"})
                continue
            if op == "spmm" and kind == "routed":
                emit({**base, "status": "skip: routed is SpMV-only"})
                continue
            reason = _feasible(kind, A, op)
            if reason:
                emit({**base, "status": f"skip: {reason}"})
                continue
            try:
                if kind == "routed":  # plan-time coloring costs seconds
                    plan = cached_plan(
                        f".bench_cache/planmatrix_{cname}_routed.npz",
                        lambda: make_plan(A, dtype=jnp.float32,
                                          force="routed"),
                        valid=lambda p: (p.shape == A.shape
                                         and p.nnz == A.nnz))
                else:
                    plan = make_plan(A, dtype=jnp.float32, force=kind)
            except Exception as e:
                emit({**base, "status": f"skip: build failed: {e}"})
                continue
            try:
                if op == "spmv":
                    if want_mv is None:
                        want_mv = spmv_cpu(A, DenseVector(np.asarray(x)),
                                           1.0, 1.0,
                                           DenseVector(np.asarray(y0)))
                    assert_equal(np.asarray(spmv(plan, x, 1.0, 1.0, y0)),
                                 want_mv, relative=True)
                    ms = _time_entry(_mv_step, y0, (plan, x))
                else:
                    if want_mm is None:
                        want_mm = spmm_cpu(A, DenseMatrix(np.asarray(B)),
                                           1.0, 1.0,
                                           DenseMatrix(np.asarray(C0)))
                    assert_equal(np.asarray(spmm(plan, B, 1.0, 1.0, C0)),
                                 want_mm, relative=True)
                    ms = _time_entry(_mm_step, C0, (plan, B))
            except Exception as e:
                emit({**base, "status": f"fail: {type(e).__name__}: {e}"})
                continue
            emit({**base, "ms": round(ms, 5), "status": "ok"})
    return 0


def report() -> int:
    rows = []
    with open(RESULTS) as fh:
        rows = [json.loads(line) for line in fh]
    by = {}
    for r in rows:
        by.setdefault((r["class"], r["op"]), {})[r["kind"]] = r
    lines = [
        "# Plan-selection robustness matrix",
        "",
        f"Measured on {rows[0].get('device_kind', 'an unrecorded device')}"
        " (two-point estimator for sub-2ms",
        "kernels; see `experiments/plan_matrix.py`).  Auto is priced at its chosen",
        "kind's forced timing (identical plans).  `--` = layout skipped",
        "(infeasible memory / structural guard) or failed; skip reasons",
        "are in `plan_matrix_results.jsonl`.",
        "",
        "| class | op | " + " | ".join(
            ["dia", "routed", "bsr", "ell", "wcoo", "coo"])
        + " | auto choice | auto/best |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    worst = (0.0, None)
    for (cname, op), kinds in sorted(by.items()):
        cells = []
        best = (float("inf"), None)
        for k in ("dia", "routed", "bsr", "ell", "wcoo", "coo"):
            r = kinds.get(k)
            if r and r.get("ms") is not None and r["status"] == "ok":
                cells.append(f"{r['ms']:.3f}")
                if r["ms"] < best[0]:
                    best = (r["ms"], k)
            else:
                cells.append("--")
        auto = kinds.get("auto", {}).get("choice", "?")
        auto_ms = kinds.get(auto, {}).get("ms")
        if auto_ms is not None and best[1] is not None:
            ratio = auto_ms / best[0]
            mark = "" if ratio <= TARGET else " **MISS**"
            ratio_s = f"{ratio:.2f}x{mark}"
            if ratio > worst[0]:
                worst = (ratio, (cname, op))
        else:
            ratio_s = "--"
        lines.append(f"| {cname} | {op} | " + " | ".join(cells)
                     + f" | {auto} | {ratio_s} |")
    lines += ["", f"Worst auto/best ratio: {worst[0]:.2f}x at {worst[1]} "
                  f"(target <= {TARGET}x).", ""]
    with open(REPORT, "w") as fh:
        fh.write("\n".join(lines))
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--report" in args:
        raise SystemExit(report())
    only = None
    if "--classes" in args:
        only = set(args[args.index("--classes") + 1].split(","))
    raise SystemExit(run(only))
