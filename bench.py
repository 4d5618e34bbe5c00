#!/usr/bin/env python3
"""Headline benchmark.  Prints ONE JSON line on stdout:

    {"metric": "ref_workloads_geomean_speedup", "value": N, "unit": "x",
     "vs_baseline": N}

Covers BOTH of the reference's benchmark workloads (profiling.sh:6-21):
CSR SpMM K=64 on the s3dkq4m2-structure proxy (`fem_shell_like`: FEM
cylindrical-shell mesh, n=90449, ~4.8M nnz, ~2.4k bandwidth with sparse
stripes — the real matrix's aggregate stats) and CSR SpMV on the
webbase-1M proxy (`webbase_like`: 1M rows, power-law out-degree, column
locality + Zipf in-degree hubs) — synthesized because the environment has
no network egress.  `value` is the geometric mean of the two speedups of
the best planned path over the framework's Tier-0 path (plain COO gather +
segment_sum under jit — the faithful translation of what the reference
delegates to cuSPARSE), since the reference publishes no absolute
numbers.  Speedups are UNCLAMPED — a plan losing to tier-0 would
report < 1x.  Absolute GFLOP/s / nnz/s per workload go to stderr, plus a
secondary unstructured-SpMM figure (webbase x K=64).

Timing runs K iterations inside one jitted fori_loop with the carry
threaded through the op inputs (see sblas/utils/benchtime.py — one
dispatch per K device executions keeps host overhead out of the number).
Plans are passed as loop ARGUMENTS, not closure captures: captured arrays
embed in the program as constants.

Results are correctness-checked against the CPU oracle before any number
is reported.  Run it on the GPU (`python bench.py`); it exits non-zero on
any other platform.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.ops import make_plan, spmm, spmv
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    from sblas.ops.plans import CooPlan
    from sblas.ops.spmm import spmm_coo
    from sblas.ops.spmv import spmv_coo
    from sblas.utils.benchtime import dispatch_overhead_ms, \
        loop_time2_ms, loop_time_ms
    from sblas.utils.compile_cache import enable_compile_cache
    from sblas.utils.timing import gflops, nnz_per_s, spmm_flops
    from sblas.utils.verify import assert_equal, check_equal

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"# device: {dev.device_kind} ({dev.platform}) x "
          f"{len(jax.devices())}, dispatch overhead "
          f"{dispatch_overhead_ms():.2f} ms", file=sys.stderr)

    repeats = {}

    def timed3(name, timer, *t_args, **t_kw):
        """Repeatability contract: every headline is three INDEPENDENT
        timer runs; the median is the canonical number, min/spread ride
        the JSON line so a ~5% regression is distinguishable from capture
        noise.  Spread > 5% warns but never fails."""
        ts = sorted(timer(*t_args, **t_kw) for _ in range(3))
        spread = (ts[-1] - ts[0]) / max(ts[0], 1e-9)
        if spread > 0.05:
            print(f"# WARN {name}: repeat spread {spread * 100:.1f}% > 5% "
                  f"({', '.join(f'{t:.4f}' for t in ts)} ms) — chip noise "
                  f"or a real instability; median is reported",
                  file=sys.stderr)
        repeats[name] = {"min_ms": round(ts[0], 5),
                         "median_ms": round(ts[1], 5),
                         "spread": round(spread, 4)}
        return ts[1]

    # ---- headline 1: SpMM K=64 on the s3dkq4m2 shell proxy ----
    K = 64
    A = fem_shell_like(dtype=np.float32)  # n=90449, ~4.8M nnz, ~2.4k band
    B = jnp.asarray(DenseMatrix.random(A.width, K, dtype=np.float32).values)
    C0 = jnp.asarray(
        DenseMatrix.constant(A.height, K, 1.0, dtype=np.float32).values)

    base_plan = CooPlan.from_csr(A, dtype=jnp.float32)
    best_plan = make_plan(A, dtype=jnp.float32, op="spmm")

    # correctness gate before timing
    want = spmm_cpu(A, DenseMatrix(np.asarray(B)), 1.0, 1.0,
                    DenseMatrix(np.asarray(C0)))
    assert_equal(np.asarray(spmm(best_plan, B, 1.0, 1.0, C0)), want,
                 relative=True)

    # coupling rules: the carry MUST be the accumulate operand (C), and
    # the primary-operand eps must be NONZERO — 0.0*carry folds away and
    # lets XLA hoist loop-invariant stages out of the loop; an eps with a
    # FIXED accumulate operand can compile a different, slower loop
    def step_base(C, plan):
        return spmm_coo(plan, B + 1e-6 * C[:1].mean(), 1.0, 1.0, C)

    def step_best(C, plan):
        return spmm(plan, B + 1e-6 * C[:1].mean(), 1.0, 1.0, C)

    # sub-2ms kernels get the two-point estimator, which cancels the
    # per-run dispatch constant instead of subtracting a separately
    # measured one
    ms_base = loop_time_ms(step_base, C0, args=(base_plan,))
    ms_best = timed3("spmm_shell", loop_time2_ms, step_best, C0, iters=64,
                     args=(best_plan,))  # unclamped
    flops = spmm_flops(A.nnz, K)
    g_best = gflops(flops, ms_best)
    print(f"# spmm k64 shell (n={A.shape[0]}, nnz={A.nnz}): "
          f"baseline {gflops(flops, ms_base):.1f} GFLOP/s ({ms_base:.3f} ms),"
          f" best[{type(best_plan).__name__}] {g_best:.1f} GFLOP/s "
          f"({ms_best:.3f} ms)", file=sys.stderr)

    # ---- headline 2: SpMV on webbase-1M-like (locality + in-degree skew) --
    W = webbase_like(dtype=np.float32)
    xw0 = jnp.asarray(DenseVector.random(W.width, dtype=np.float32).values)
    yw = jnp.asarray(
        DenseVector.constant(W.height, 1.0, dtype=np.float32).values)
    wbase = CooPlan.from_csr(W, dtype=jnp.float32)
    # plan cache: the routed plan's analysis (edge coloring over ~nnz
    # edges) costs seconds of host time; persist it like FFTW wisdom
    # (the cache is keyed by file name).
    from sblas.io.plancache import load_plan, save_plan

    def cached_plan(name, build, valid=None):
        """FFTW-wisdom load with a rebuild fallback: a cache file from an
        older plan schema (FormatError) must not kill the bench run, and a
        cache that fails the caller's `valid` predicate (geometry drift
        after a generator/analyzer change) must not silently time the
        wrong plan."""
        path = os.path.join(".bench_cache", name)
        if os.path.exists(path):
            try:
                plan = load_plan(path)
                if valid is None or valid(plan):
                    return plan
                print(f"# plan cache {name} stale (geometry mismatch); "
                      f"rebuilding", file=sys.stderr)
            except Exception as e:  # stale schema / truncated file
                print(f"# plan cache {name} unusable ({e}); rebuilding",
                      file=sys.stderr)
        plan = build()
        os.makedirs(".bench_cache", exist_ok=True)
        save_plan(path, plan)
        return plan

    # v4: heavy-row stack-cap splitting added to the routed plan
    wbest = cached_plan("webbase_spmv_f32_v4.npz",
                        lambda: make_plan(W, dtype=jnp.float32, op="spmv"))
    assert_equal(
        np.asarray(spmv(wbest, xw0, 1.0, 1.0, yw)),
        spmv_cpu(W, DenseVector(np.asarray(xw0)), 1.0, 1.0,
                 DenseVector(np.asarray(yw))), relative=True)

    def wstep_base(y, plan):
        return spmv_coo(plan, xw0 + 1e-6 * y, 1.0, 1.0, y)

    def wstep_best(y, plan):
        return spmv(plan, xw0 + 1e-6 * y, 1.0, 1.0, y)

    ms_wb = loop_time_ms(wstep_base, yw, args=(wbase,))
    ms_wbest = timed3("spmv_webbase", loop_time2_ms, wstep_best, yw,
                      iters=128, args=(wbest,))  # unclamped
    print(f"# spmv webbase-1M-like (nnz={W.nnz}): baseline "
          f"{nnz_per_s(W.nnz, ms_wb):.3e} nnz/s ({ms_wb:.3f} ms), best"
          f"[{type(wbest).__name__}] {nnz_per_s(W.nnz, ms_wbest):.3e} nnz/s "
          f"({ms_wbest:.3f} ms)", file=sys.stderr)

    # informational: opt-in bf16 route transport (documented 2e-3 relative
    # bar — OUTSIDE the reference's 1e-3, so it never feeds the headline;
    # oracle-gated at its own bar before timing)
    if hasattr(wbest, "with_transport"):
        wbest16 = wbest.with_transport("bf16")
        rep16 = check_equal(
            np.asarray(spmv(wbest16, xw0, 1.0, 1.0, yw)),
            spmv_cpu(W, DenseVector(np.asarray(xw0)), 1.0, 1.0,
                     DenseVector(np.asarray(yw))),
            error_bar=2e-3, relative=True)
        if rep16.ok:
            ms_w16 = loop_time2_ms(wstep_best, yw, iters=128,
                                   args=(wbest16,))
            print(f"# spmv webbase bf16 transport (opt-in, 2e-3 bar): "
                  f"{nnz_per_s(W.nnz, ms_w16):.3e} nnz/s ({ms_w16:.3f} ms, "
                  f"{ms_wbest / ms_w16:.2f}x over f32)", file=sys.stderr)
        else:
            print(f"# spmv webbase bf16 transport FAILED its bar: {rep16}",
                  file=sys.stderr)

    # ---- secondary: unstructured SpMM K=64 on the webbase proxy ----
    # (not a reference workload — s3dkq4m2 is the SpMM benchmark — but the
    # SpMM story must cover both structure classes)
    Bw = jnp.asarray(DenseMatrix.random(W.width, K, dtype=np.float32).values)
    Cw0 = jnp.asarray(
        DenseMatrix.constant(W.height, K, 1.0, dtype=np.float32).values)
    wm_plan = make_plan(W, dtype=jnp.float32, op="spmm")
    assert_equal(
        np.asarray(spmm(wm_plan, Bw, 1.0, 1.0, Cw0)),
        spmm_cpu(W, DenseMatrix(np.asarray(Bw)), 1.0, 1.0,
                 DenseMatrix(np.asarray(Cw0))), relative=True)

    def wmstep(C, plan):
        return spmm(plan, Bw + 1e-6 * C[:1].mean(), 1.0, 1.0, C)

    ms_wm = timed3("spmm_webbase_wcoo", loop_time_ms, wmstep, Cw0,
                   args=(wm_plan,), reps=3)
    print(f"# spmm k64 webbase (unstructured, {type(wm_plan).__name__}): "
          f"{ms_wm:.3f} ms = {gflops(spmm_flops(W.nnz, K), ms_wm):.1f} "
          f"GFLOP/s = {nnz_per_s(W.nnz, ms_wm):.3e} nnz/s", file=sys.stderr)

    # xfoot (footprint-compressed x-exchange): real plan-time exchange
    # geometry + per-shard compute of the heaviest shard's local plan
    # (exactly what every shard executes inside the shard_map program)
    from sblas.ops.rspmv import RoutedPlan, spmv_routed
    from sblas.parallel.xfoot import xfoot_stats, xfoot_worst_local
    for nsh in (4, 16):
        xf = xfoot_stats(W, nsh)
        local, (tg, srs, prs, sks) = xfoot_worst_local(W, nsh)
        lplan = cached_plan(
            f"webbase_xfoot_shard{nsh}_f32_v1.npz",
            lambda: RoutedPlan.from_csr(local, dtype=jnp.float32,
                                        min_gtiles=tg, min_srows=srs,
                                        min_prows=prs, min_sranks=sks),
            # the probe is computed fresh above, so a stale cache (e.g.
            # after a generator or analyzer change) is detectable: the
            # cached plan must match the shard geometry and static sizes
            valid=lambda p: (p.shape == local.shape and p.nnz == local.nnz
                             and p.n_gtiles >= tg and p.n_srows >= srs
                             and p.n_prows >= prs))
        xl = jnp.asarray(
            DenseVector.random(local.shape[1], dtype=np.float32).values)
        yl = jnp.zeros(local.shape[0], jnp.float32)

        def sstep(yc, p, xv):
            return spmv_routed(p, xv + 1e-6 * yc[0], 1.0, 1.0, yc)

        # two-point estimator: a shard loop runs in microseconds, so the
        # per-run dispatch constant must cancel
        shard_ms = timed3(f"xfoot_shard{nsh}", loop_time2_ms, sstep, yl,
                          iters=1024, args=(lplan, xl))
        print(f"# xfoot[spmv] n={nsh}: shard compute "
              f"{shard_ms * 1e3:.1f} us (measured), hot {xf.hot_total}, "
              f"packets {xf.packet_pad}/pair, extract {xf.extract_mode}",
              file=sys.stderr)
    # weak-scaling shard cell: the heaviest of 4 shards of a 4M-row
    # proxy (1M rows per shard, the single-chip workload's size).  The
    # 4M-row proxy generation + full xfoot analysis costs seconds of host
    # time per run; its XFootStats are plan-time constants, so they
    # persist in a JSON sidecar keyed to the plan cache — on a joint hit
    # the W4 matrix is never regenerated (stale pairs are caught by the
    # shape/nnz fingerprint recorded in the sidecar vs the cached plan)
    from sblas.parallel.xfoot import XFootStats
    st4_path = os.path.join(".bench_cache", "webbase4m_xfoot_stats_v1.json")
    plan4_path = os.path.join(".bench_cache",
                              "webbase4m_xfoot_shard4_f32_v1.npz")
    st4 = lplan4 = None
    if os.path.exists(st4_path) and os.path.exists(plan4_path):
        try:
            with open(st4_path) as fh:
                side = json.load(fh)
            lplan4 = load_plan(plan4_path)
            if (tuple(side["plan_shape"]) == tuple(lplan4.shape)
                    and side["plan_nnz"] == lplan4.nnz):
                st4 = XFootStats(**side["stats"])
            else:
                lplan4 = None
        except Exception as e:
            print(f"# W4 cache unusable ({e}); rebuilding", file=sys.stderr)
            st4 = lplan4 = None
    if st4 is None or lplan4 is None:
        W4 = webbase_like(n=4_000_000, dtype=np.float32)
        st4 = xfoot_stats(W4, 4)

        def _build4():
            local4, (tg, srs, prs, sks) = xfoot_worst_local(W4, 4)
            return RoutedPlan.from_csr(local4, dtype=jnp.float32,
                                       min_gtiles=tg, min_srows=srs,
                                       min_prows=prs, min_sranks=sks)

        lplan4 = cached_plan(os.path.basename(plan4_path), _build4)
        os.makedirs(".bench_cache", exist_ok=True)
        with open(st4_path, "w") as fh:
            json.dump({"stats": st4._asdict(),
                       "plan_shape": list(lplan4.shape),
                       "plan_nnz": int(lplan4.nnz)}, fh)
    xl4 = jnp.asarray(
        DenseVector.random(lplan4.shape[1], dtype=np.float32).values)
    yl4 = jnp.zeros(lplan4.shape[0], jnp.float32)

    def w4step(yc, p, xv):
        return spmv_routed(p, xv + 1e-6 * yc[0], 1.0, 1.0, yc)

    ms4 = timed3("spmv_weak_shard4", loop_time2_ms, w4step, yl4,
                 iters=128, args=(lplan4, xl4))
    print(f"# spmv weak shard n=4 (1M rows/shard of a 4M-row proxy): "
          f"{ms4:.3f} ms, x-exchange {st4.comm_bytes(4) / 1e6:.2f} MB",
          file=sys.stderr)

    geomean = float(np.sqrt((ms_base / ms_best) * (ms_wb / ms_wbest)))
    print(f"# spmm speedup {ms_base/ms_best:.1f}x, spmv speedup "
          f"{ms_wb/ms_wbest:.1f}x, spmm {g_best:.1f} GFLOP/s, spmv "
          f"{nnz_per_s(W.nnz, ms_wbest):.3e} nnz/s", file=sys.stderr)
    print(json.dumps({
        "metric": "ref_workloads_geomean_speedup",
        "value": round(geomean, 3),
        "unit": "x",
        "vs_baseline": round(geomean, 4),
        # each headline timed as three independent runs; `value` is
        # computed from medians
        "repeats": repeats,
    }))
    return 0


if __name__ == "__main__":
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU found (platform "
              f"{jax.devices()[0].platform!r}); timings are device metrics "
              f"and are only taken on the card", file=sys.stderr)
        raise SystemExit(1)
    raise SystemExit(main())
