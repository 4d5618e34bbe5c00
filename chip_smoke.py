#!/usr/bin/env python3
"""Smoke test of the SpMV/SpMM main path on the GPU, at full size.

    python chip_smoke.py               # one card: phases a-e
    python chip_smoke.py --devices 4   # four cards: phase f only

Phases (every line names the device):

  a  device   card name and power limit (nvidia-smi), device kind and
              count, JAX version; fails unless the platform is "gpu".
  b  cli      both reference workloads written as .mtx by
              matrices/gen_matrices.py, then the spmv/spmm drivers run
              in-process on one device; each must print Validation = True.
  c  kernels  every plan kind make_plan(force=...) can build (within a
              plan-size cap) plus cuSPARSE CSR through
              jax.experimental.sparse, for SpMV on the webbase proxy and
              SpMM K=64 on the shell proxy: one oracle check each, then
              the median wall time of >= 20 block_until_ready calls and
              the device time per call from a two-point fori_loop; also
              make_plan's pick and whether it is within 10% of the best
              kind.  The contract metric is the wall median (what a
              caller pays per call); the device-time ratio is printed
              beside it for information.
  d  um       spmv_um / spmm_um, tuning off and on, with an HBM budget
              below the operand size so bands really stream; reports
              whether one streamed chunk's device temporaries fit the
              budget (they need not: the budget is a target).
  e  solver   CG on an SPD shell-proxy system; then one f64 SpMV against
              the oracle at the absolute 1e-3 bar.
  f  multi    (--devices 4 only) modes 1 and 2 (psum, psum_scatter), the
              planned, halo, xfoot and host-streamed distributed paths over
              a 1-D mesh of four cards, each checked against the oracle.

f32 results must match the CPU oracle to relative 1e-3; every f32 dot
runs at Precision.HIGHEST.  A failing phase raises, so the script exits
non-zero and prints no result line.  The last line of stdout is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REL = 1e-3           # f32 oracle bar (relative), the reference's ERROR_BAR
CALLS = 30           # timed calls per kernel (median reported)
PLAN_BYTES_CAP = 4 << 30   # kinds whose padded layout exceeds this are
                           # reported as not buildable for the workload
K = 64               # SpMM width of the reference benchmark

_TAG = "?"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {_TAG}: {msg}", flush=True)


def check(phase: str, what: str, got, want, relative: bool = True,
          bar: float = REL) -> None:
    from sblas.utils.verify import check_equal
    rep = check_equal(np.asarray(got), want, error_bar=bar,
                      relative=relative)
    say(phase, f"{what}: {rep}")
    if not rep.ok:
        raise AssertionError(f"[{phase}] {what} failed the oracle: {rep}")


def loop_ms(fn, X, Y, iters: int = 256) -> float:
    """Device time per call of fn(X, Y) -> Y': two-point fori_loop with
    the output fed back into both operands (so no iteration can be
    hoisted), dispatch cancelled between the two loop lengths."""
    import jax.numpy as jnp

    from sblas.utils.benchtime import loop_time2_ms

    def step(Yc, X_):
        return fn(X_ + 1e-6 * jnp.mean(Yc[:1]), Yc)
    return loop_time2_ms(step, Y, iters=iters, reps=3, args=(X,))


def median_ms(fn, *args, calls: int = CALLS) -> float:
    """Median wall time of `calls` block_until_ready calls, after one
    warm-up call (which compiles)."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# a: device
# ---------------------------------------------------------------------------

def phase_device(require_gpu: bool = True) -> dict:
    import jax
    global _TAG
    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    _TAG = f"{d.device_kind} x{len(devs)}"
    if require_gpu and d.platform != "gpu":
        print(f"chip_smoke: no GPU found (platform {d.platform!r})",
              file=sys.stderr)
        raise SystemExit(1)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable ({e})"
    for line in smi.splitlines() or [smi]:
        say("a device", f"nvidia-smi: {line}")
    say("a device", f"platform {d.platform}, device_kind {d.device_kind}, "
        f"count {len(devs)}, jax {jax.__version__}")
    return info


# ---------------------------------------------------------------------------
# b: cli
# ---------------------------------------------------------------------------

def _load_gen_matrices():
    spec = importlib.util.spec_from_file_location(
        "gen_matrices", os.path.join(HERE, "matrices", "gen_matrices.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_cli(outdir: str, small: bool = False) -> None:
    import contextlib
    import io

    from sblas.cli import spmm_test, spmv_test
    gen = _load_gen_matrices()
    t0 = time.perf_counter()
    assert gen.main((["--small"] if small else []) + [outdir]) == 0
    say("b cli", f"wrote .mtx workloads to {outdir} "
        f"({time.perf_counter() - t0:.1f} s)")
    runs = [("spmv_test", spmv_test.main,
             [os.path.join(outdir, "webbase-1M-like.mtx"), "1.0", "1.0",
              "1"]),
            ("spmm_test", spmm_test.main,
             ["1", os.path.join(outdir, "s3dkq4m2-like.mtx"), str(K),
              "1.0", "1.0", "1"])]
    for name, fn, argv in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        out = buf.getvalue()
        for line in out.splitlines():
            if (line.startswith(("Matrix", "1-device run"))
                    or "max_abs" in line):
                say("b cli", f"{name}: {line}")
        if rc != 0 or "Validation = True" not in out:
            print(out, file=sys.stderr)
            raise AssertionError(f"[b cli] {name} {argv} rc={rc}")
        say("b cli", f"{name} ok ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# c: kernels
# ---------------------------------------------------------------------------

KINDS = ("dia", "bsr", "ell", "wcoo", "coo", "routed")


def kind_of(plan) -> str:
    from sblas.ops import (BsrPlan, CooPlan, DiaPlan, EllPlan, RoutedPlan,
                           WcooPlan)
    return {DiaPlan: "dia", BsrPlan: "bsr", EllPlan: "ell",
            WcooPlan: "wcoo", CooPlan: "coo",
            RoutedPlan: "routed"}[type(plan)]


def plan_bytes(A, kind: str, itemsize: int = 4) -> float:
    """Device bytes of a forced layout, estimated from structure alone
    (before building it)."""
    from sblas.config import DEFAULT
    from sblas.ops.bsr import bell_stats
    from sblas.ops.dia import dia_stats
    m = A.shape[0]
    if kind == "dia":
        return dia_stats(A)["n_diags"] * m * itemsize
    if kind == "bsr":
        return bell_stats(A, DEFAULT.bsr_block)["blowup"] * A.nnz * itemsize
    if kind == "ell":
        return -(-m // 8) * 8 * max(int(A.row_nnz.max()), 1) * (itemsize + 4)
    return A.nnz * (itemsize + 12) * 2   # nnz-proportional layouts


def cusparse_fn(op: str, shape):
    """beta*Y + alpha*A@X with A as CSR through jax.experimental.sparse
    (cuSPARSE on CUDA, XLA elsewhere)."""
    import jax
    from jax.experimental import sparse
    from jax.experimental.sparse.csr import csr_matmat, csr_matvec
    prod = csr_matvec if op == "spmv" else csr_matmat

    @jax.jit
    def f(data, indices, indptr, X, alpha, beta, Y):
        A = sparse.CSR((data, indices, indptr), shape=shape)
        return beta * Y + alpha * prod(A, X)
    return f


def bench_workload(A, op: str, X, Y, want, alpha: float, beta: float,
                   calls: int = CALLS, iters: int = 256) -> dict:
    """Build, check and time every buildable kind for one workload.
    Returns {kind: (wall ms, device ms), "cusparse": (...),
    "_pick": kind}."""
    import gc

    import jax.numpy as jnp

    from sblas.ops import make_plan, spmm, spmv
    run = spmv if op == "spmv" else spmm
    phase = "c kernels"
    name = f"{op} {A.shape[0]}x{A.shape[1]} nnz={A.nnz}"
    out = {}
    t0 = time.perf_counter()
    auto = make_plan(A, dtype=jnp.float32, op=op)
    out["_pick"] = pick = kind_of(auto)
    say(phase, f"{name}: make_plan picks {pick} "
        f"(build {time.perf_counter() - t0:.1f} s)")
    for kind in KINDS:
        if kind == "routed" and op != "spmv":
            continue
        est = plan_bytes(A, kind)
        if kind != pick and est > PLAN_BYTES_CAP:
            say(phase, f"{name}: {kind} not buildable "
                f"({est / 2**30:.1f} GiB padded layout > "
                f"{PLAN_BYTES_CAP / 2**30:.0f} GiB cap)")
            continue
        t0 = time.perf_counter()
        plan = auto if kind == pick else make_plan(
            A, dtype=jnp.float32, force=kind, op=op)
        build_s = time.perf_counter() - t0
        check(phase, f"{name} {kind}", run(plan, X, alpha, beta, Y), want)
        out[kind] = (median_ms(run, plan, X, alpha, beta, Y, calls=calls),
                     loop_ms(lambda X_, Y_, p=plan: run(p, X_, alpha, beta,
                                                        Y_), X, Y, iters))
        say(phase, f"{name} {kind}: wall {out[kind][0]:.4f} ms, device "
            f"{out[kind][1]:.4f} ms (build {build_s:.1f} s)")
        del plan
        gc.collect()
    del auto
    gc.collect()
    csr = (jnp.asarray(A.values.astype(np.float32)),
           jnp.asarray(A.col_idx.astype(np.int32)),
           jnp.asarray(A.row_ptr.astype(np.int32)))
    f = cusparse_fn(op, A.shape)
    hlo = f.lower(*csr, X, alpha, beta, Y).as_text()
    check(phase, f"{name} cusparse", f(*csr, X, alpha, beta, Y), want)
    out["cusparse"] = (median_ms(f, *csr, X, alpha, beta, Y, calls=calls),
                       loop_ms(lambda X_, Y_: f(*csr, X_, alpha, beta, Y_),
                               X, Y, iters))
    say(phase, f"{name} cusparse: wall {out['cusparse'][0]:.4f} ms, device "
        f"{out['cusparse'][1]:.4f} ms (custom call "
        f"{'present' if 'cusparse' in hlo else 'absent'})")
    for i, metric in enumerate(("contract, wall median",
                                "device time, not the contract")):
        t = {k: v[i] for k, v in out.items() if k in KINDS}
        best = min(t, key=t.get)
        ratio = t[pick] / t[best]
        say(phase, f"{name} ({metric}): pick {pick} {t[pick]:.4f} ms, "
            f"best {best} {t[best]:.4f} ms, ratio {ratio:.3f} -> "
            f"{'within' if ratio <= 1.10 else 'NOT within'} 10% of the "
            f"best")
    return out


def phase_kernels(web, shell, calls: int = CALLS, iters: int = 256) -> dict:
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    x = DenseVector.random(web.width, dtype=np.float32)
    y = DenseVector.constant(web.height, 1.0, dtype=np.float32)
    res = {"spmv": bench_workload(
        web, "spmv", jnp.asarray(x.values), jnp.asarray(y.values),
        spmv_cpu(web, x, 3.0, 4.0, y), 3.0, 4.0, calls=calls, iters=iters)}
    B = DenseMatrix.random(shell.width, K, dtype=np.float32)
    C = DenseMatrix.constant(shell.height, K, 1.0, dtype=np.float32)
    res["spmm"] = bench_workload(
        shell, "spmm", jnp.asarray(B.values), jnp.asarray(C.values),
        spmm_cpu(shell, B, 3.0, 4.0, C), 3.0, 4.0, calls=calls, iters=iters)
    say("c kernels", "table " + json.dumps(
        {op: {k: v for k, v in r.items()} for op, r in res.items()}))
    return res


# ---------------------------------------------------------------------------
# d: um
# ---------------------------------------------------------------------------

def _operand_bytes(hplan) -> int:
    import jax
    return sum(a.nbytes for b in hplan.bands
               for a in jax.tree_util.tree_leaves(b))


def phase_um(web, shell, budget: int = 16 << 20) -> None:
    import jax
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.memory import host as um
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    phase = "d um"
    kinds = {m.kind for m in jax.devices()[0].addressable_memories()}
    say(phase, f"memory kinds {sorted(kinds)}")

    x = DenseVector.random(web.width, dtype=np.float32)
    y = DenseVector.constant(web.height, 1.0, dtype=np.float32)
    want = spmv_cpu(web, x, 2.0, 3.0, y)
    hp = um.host_resident_plan(web, dtype=jnp.float32,
                               hbm_budget_bytes=budget)
    op_bytes = _operand_bytes(hp)
    say(phase, f"spmv_um: {hp.n_bands} {hp.kind} bands, operand "
        f"{op_bytes / 2**20:.1f} MiB pinned_host "
        f"({hp.bands[0].vals.sharding.memory_kind}), budget "
        f"{budget / 2**20:.0f} MiB")
    if hp.n_bands < 2 or op_bytes <= budget:
        raise AssertionError("[d um] operand does not exceed the budget")
    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    G = um._stream_chunk()
    chunk = tuple(hp.bands[:G])
    ma = um._chunk_matvec.lower(hp.kind, chunk, xd).compile() \
        .memory_analysis()
    say(phase, f"spmv_um chunk of {len(chunk)} bands: {ma}")
    temp = ma.temp_size_in_bytes + ma.output_size_in_bytes
    say(phase, f"spmv_um chunk device temporaries + output "
        f"{temp / 2**20:.1f} MiB vs budget {budget / 2**20:.0f} MiB -> "
        f"{'within' if temp <= budget else 'EXCEEDS'} budget")
    for tuning in (False, True):
        check(phase, f"spmv_um tuning={tuning}",
              um.spmv_um(hp, xd, 2.0, 3.0, yd, tuning=tuning), want)
        ms = median_ms(lambda: um.spmv_um(hp, xd, 2.0, 3.0, yd,
                                          tuning=tuning), calls=10)
        say(phase, f"spmv_um tuning={tuning}: {ms:.3f} ms/call")
    hp.remove_gpu_tuning()
    del hp

    B = DenseMatrix.random(shell.width, K, dtype=np.float32)
    C = DenseMatrix.constant(shell.height, K, 1.0, dtype=np.float32)
    want = spmm_cpu(shell, B, 2.0, 3.0, C)
    hp = um.host_resident_plan(shell, dtype=jnp.float32,
                               hbm_budget_bytes=budget)
    op_bytes = _operand_bytes(hp)
    say(phase, f"spmm_um: {hp.n_bands} {hp.kind} bands, operand "
        f"{op_bytes / 2**20:.1f} MiB, budget {budget / 2**20:.0f} MiB")
    if hp.n_bands < 2 or op_bytes <= budget:
        raise AssertionError("[d um] operand does not exceed the budget")
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)
    for tuning in (False, True):
        check(phase, f"spmm_um tuning={tuning}",
              um.spmm_um(hp, Bd, 2.0, 3.0, Cd, tuning=tuning), want)
        ms = median_ms(lambda: um.spmm_um(hp, Bd, 2.0, 3.0, Cd,
                                          tuning=tuning), calls=10)
        say(phase, f"spmm_um tuning={tuning}: {ms:.3f} ms/call")
    hp.remove_gpu_tuning()


# ---------------------------------------------------------------------------
# e: solver (+ one f64 SpMV)
# ---------------------------------------------------------------------------

def spd_system(A):
    """Symmetric, strictly diagonally dominant (hence SPD) matrix on A's
    pattern: |A| + |A|^T off the diagonal, 1 + row sum on it."""
    from sblas.containers import CooMatrix
    coo, cot = A.to_coo(), A.transpose().to_coo()
    rows = np.concatenate([coo.row_idx, cot.row_idx])
    cols = np.concatenate([coo.col_idx, cot.col_idx])
    vals = np.abs(np.concatenate([coo.values, cot.values])).astype(np.float64)
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    rowsum = np.bincount(rows, weights=vals, minlength=A.shape[0])
    d = np.arange(A.shape[0])
    return CooMatrix(np.concatenate([rows, d]), np.concatenate([cols, d]),
                     np.concatenate([vals, 1.0 + rowsum]),
                     A.shape).to_csr()


def phase_solver(shell, tol: float = 1e-5) -> None:
    import jax.numpy as jnp

    from sblas.ops import make_plan
    from sblas.ops.cpu_reference import _csr_matvec
    from sblas.solvers import cg
    phase = "e solver"
    S = spd_system(shell)
    S32 = type(S)(S.row_ptr, S.col_idx, S.values.astype(np.float32), S.shape)
    x_true = np.random.RandomState(7).standard_normal(S.shape[0])
    b = _csr_matvec(S.row_ptr, S.col_idx, S.values, x_true)
    plan = make_plan(S32, dtype=jnp.float32, op="spmv")
    t0 = time.perf_counter()
    res = cg(plan, jnp.asarray(b, jnp.float32), tol=tol, maxiter=1000)
    x = np.asarray(res.x, np.float64)
    wall = time.perf_counter() - t0
    host_res = (np.linalg.norm(b - _csr_matvec(S.row_ptr, S.col_idx,
                                               S.values, x))
                / np.linalg.norm(b))
    say(phase, f"cg on SPD shell proxy n={S.shape[0]} nnz={S.nnz} "
        f"({kind_of(plan)}): {res.iterations} iterations, device residual "
        f"{res.residual:.2e}, host f64 residual {host_res:.2e}, "
        f"{wall:.2f} s incl. compile")
    if not res.converged or host_res > 10 * tol:
        raise AssertionError(f"[e solver] cg did not reach tol {tol}")


def phase_f64(web) -> None:
    """Native f64 SpMV against the oracle at the absolute 1e-3 bar (turns
    on x64, so it runs last)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from sblas.containers import CsrMatrix, DenseVector
    from sblas.ops import make_plan, spmv
    from sblas.ops.cpu_reference import spmv_cpu
    A = CsrMatrix(web.row_ptr, web.col_idx, web.values.astype(np.float64),
                  web.shape)
    x = DenseVector.random(A.width, dtype=np.float64)
    y = DenseVector.constant(A.height, 1.0, dtype=np.float64)
    plan = make_plan(A, dtype=jnp.float64, op="spmv")
    got = spmv(plan, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values))
    check("e solver", f"f64 spmv ({kind_of(plan)}, absolute bar)", got,
          spmv_cpu(A, x, 3.0, 4.0, y), relative=False)


# ---------------------------------------------------------------------------
# f: multi (four cards)
# ---------------------------------------------------------------------------

def phase_multi(web, shell, n: int, calls: int = 20) -> dict:
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.memory import (host_resident_shards, spmm_um_dist,
                              spmv_um_dist)
    from sblas.ops import make_plan
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    from sblas.parallel import (make_mesh, partition_halo_dia,
                                partition_row_plans, partition_xfoot,
                                spmm_halo_planned, spmm_mode1, spmm_mode2,
                                spmm_mode2_planned, spmv_dist,
                                spmv_dist_planned, spmv_halo,
                                spmv_halo_planned, spmv_xfoot)
    from sblas.partition import partition_nnz_balanced, partition_row_blocks
    phase = "f multi"
    mesh = make_mesh(n)
    out = {}

    def run(name, fn, want):
        check(phase, name, fn(), want)
        out[name] = median_ms(fn, calls=calls)
        say(phase, f"{name}: {out[name]:.4f} ms")

    # SpMM K=64 on the shell proxy
    B = DenseMatrix.random(shell.width, K, dtype=np.float32)
    C = DenseMatrix.constant(shell.height, K, 1.0, dtype=np.float32)
    Bd, Cd = jnp.asarray(B.values), jnp.asarray(C.values)
    want = spmm_cpu(shell, B, 2.0, 3.0, C)
    plan = make_plan(shell, dtype=jnp.float32)
    run(f"spmm mode1 ({kind_of(plan)})",
        lambda: spmm_mode1(plan, Bd, 2.0, 3.0, Cd, mesh), want)
    segs = partition_nnz_balanced(shell, n, dtype=jnp.float32)
    for red in ("psum", "psum_scatter"):
        run(f"spmm mode2 {red}", lambda red=red: spmm_mode2(
            segs, Bd, 2.0, 3.0, Cd, mesh, reduce=red), want)
    shards = partition_row_plans(shell, n, dtype=jnp.float32)
    for red in ("psum", "psum_scatter"):
        run(f"spmm mode2 planned ({shards.kind}) {red}",
            lambda red=red: spmm_mode2_planned(shards, Bd, 2.0, 3.0, Cd,
                                               mesh, reduce=red), want)
    hshards = partition_halo_dia(shell, n, dtype=jnp.float32)
    run("spmm halo planned (dia)",
        lambda: spmm_halo_planned(hshards, Bd, 2.0, 3.0, Cd, mesh), want)
    hs = host_resident_shards(shell, n, dtype=jnp.float32,
                              hbm_budget_bytes=16 << 20)
    run(f"spmm_um_dist ({hs.kind})",
        lambda: spmm_um_dist(hs, Bd, 2.0, 3.0, Cd, mesh), want)
    del plan, segs, shards, hshards, hs

    # SpMV on the shell proxy: the banded halo modes
    x = DenseVector.random(shell.width, dtype=np.float32)
    y = DenseVector.constant(shell.height, 1.0, dtype=np.float32)
    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    want = spmv_cpu(shell, x, 2.0, 3.0, y)
    blocks = partition_row_blocks(shell, n, dtype=jnp.float32)
    run("spmv halo (shell)",
        lambda: spmv_halo(blocks, xd, 2.0, 3.0, yd, mesh), want)
    hshards = partition_halo_dia(shell, n, dtype=jnp.float32)
    run("spmv halo planned (shell, dia)",
        lambda: spmv_halo_planned(hshards, xd, 2.0, 3.0, yd, mesh), want)
    del blocks, hshards

    # SpMV on the webbase proxy
    x = DenseVector.random(web.width, dtype=np.float32)
    y = DenseVector.constant(web.height, 1.0, dtype=np.float32)
    xd, yd = jnp.asarray(x.values), jnp.asarray(y.values)
    want = spmv_cpu(web, x, 2.0, 3.0, y)
    segs = partition_nnz_balanced(web, n, dtype=jnp.float32)
    for red in ("psum", "psum_scatter"):
        run(f"spmv dist {red}", lambda red=red: spmv_dist(
            segs, xd, 2.0, 3.0, yd, mesh, reduce=red), want)
    shards = partition_row_plans(web, n, dtype=jnp.float32)
    for red in ("psum", "psum_scatter"):
        run(f"spmv dist planned ({shards.kind}) {red}",
            lambda red=red: spmv_dist_planned(shards, xd, 2.0, 3.0, yd,
                                              mesh, reduce=red), want)
    xs = partition_xfoot(web, n, dtype=jnp.float32)
    run(f"spmv xfoot ({xs.kind}, extract {xs.stats.extract_mode})",
        lambda: spmv_xfoot(xs, xd, 2.0, 3.0, yd, mesh), want)
    hs = host_resident_shards(web, n, dtype=jnp.float32,
                              hbm_budget_bytes=16 << 20)
    run(f"spmv_um_dist ({hs.kind})",
        lambda: spmv_um_dist(hs, xd, 2.0, 3.0, yd, mesh), want)
    return out


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 runs only the multi-card phase f")
    args = ap.parse_args(argv)

    import jax
    info = phase_device()
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.utils.compile_cache import enable_compile_cache
    say("a device", f"compile cache {enable_compile_cache()}")

    t0 = time.perf_counter()
    web = webbase_like(dtype=np.float32)
    shell = fem_shell_like(dtype=np.float32)
    say("a device", f"workloads: webbase {web.shape} nnz={web.nnz}, shell "
        f"{shell.shape} nnz={shell.nnz} ({time.perf_counter() - t0:.1f} s)")

    if args.devices > 1:
        if len(jax.devices()) < args.devices:
            raise SystemExit(f"--devices {args.devices}: only "
                             f"{len(jax.devices())} visible")
        phase_multi(web, shell, args.devices)
    else:
        for name, fn in (
                ("b cli", lambda: phase_cli(os.path.join(HERE, ".smoke"))),
                ("c kernels", lambda: phase_kernels(web, shell)),
                ("d um", lambda: phase_um(web, shell)),
                ("e solver", lambda: phase_solver(shell)),
                ("e f64", lambda: phase_f64(web))):
            t0 = time.perf_counter()
            fn()
            say(name, f"passed ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
