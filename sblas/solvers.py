"""Iterative solvers composed from the plan layer.

The reference ships kernels only; production SpMV lives inside solver
loops (a NEW operand every iteration — exactly what the build-once/
run-many plans are for).  These run the WHOLE solve as one
`lax.while_loop` under a single jit dispatch, so a 500-iteration CG
pays one host round trip instead of 500.  (The examples/ scripts
keep host-side loops for progress printing; this module is the
library path.)

Plans and shard containers are threaded through the jit as ARGUMENTS,
never closure captures — captured arrays embed in the program as HLO
constants (hundreds of MB of plan tables at scale).

No reference analog (S-BLAS has no solver layer); the API follows
scipy.sparse.linalg loosely (`cg(A, b) -> (x, info)` becomes a typed
result).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

# jitted solver programs, keyed by (solver, matvec-kind, mesh, tol,
# maxiter, preconditioner identity): re-wrapping `run` in a fresh
# jax.jit on every call would RETRACE AND RECOMPILE each solve in a loop
# over right-hand sides.  Keys hold only hashables; jax.jit still
# retraces internally when operand shapes/treedefs change.
_PROGRAMS: dict = {}


def _cached_jit(key, build):
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = jax.jit(build())
    return prog


class SolveResult(NamedTuple):
    """Outcome of an iterative solve (host scalars, device solution)."""

    x: jax.Array
    iterations: int
    residual: float      # cg: ||r||/||b||; pagerank: L1 delta
    converged: bool


def _matvec_of(A, mesh=None, dtype=None) -> tuple:
    """Normalize `A` into (fn(operands, v) -> A@v, operands, key) with
    the plan data passed as a pytree argument (see module docstring).
    `key` identifies the matvec FORM for the program cache (the operand
    pytree itself stays a runtime argument).

    Accepts a raw `CsrMatrix` (planned here via `make_plan`), a
    single-chip plan (`make_plan` result), distributed shard containers
    (`RowPlanShards` with `mesh`, `XFootShards` with `mesh`), or a
    traceable callable v -> A@v (operands = ())."""
    if callable(A) and not hasattr(A, "plan") and not hasattr(A, "shape"):
        return (lambda _, v: A(v)), (), ("user", A)
    from .containers import CsrMatrix
    if isinstance(A, CsrMatrix):
        from .ops import make_plan
        A = make_plan(A, dtype=dtype or jnp.float32, op="spmv")
    from .parallel.planned import RowPlanShards
    from .parallel.xfoot import XFootShards
    if isinstance(A, RowPlanShards):
        from .parallel.planned import spmv_dist_planned
        from .utils.errors import PartitionError, require
        require(mesh is not None, PartitionError,
                "distributed shards need mesh=")
        return (lambda sh, v: spmv_dist_planned(
            sh, v, 1.0, 0.0, jnp.zeros(sh.shape[0], v.dtype), mesh)), A, \
            ("rowplan", mesh)
    if isinstance(A, XFootShards):
        from .parallel.xfoot import spmv_xfoot
        from .utils.errors import PartitionError, require
        require(mesh is not None, PartitionError,
                "distributed shards need mesh=")
        return (lambda sh, v: spmv_xfoot(
            sh, v, 1.0, 0.0, jnp.zeros(sh.shape[0], v.dtype), mesh)), A, \
            ("xfoot", mesh)
    from .ops import spmv
    return (lambda p, v: spmv(p, v, 1.0, 0.0,
                              jnp.zeros(p.shape[0], v.dtype))), A, \
        ("plan",)


def jacobi_inv_diag(A, dtype=None) -> jax.Array:
    """Inverse-diagonal (Jacobi) preconditioner vector for `cg(M=...)`.

    `A` is a `CsrMatrix`; zero/absent diagonal entries map to 1.0 (no
    preconditioning on that row) rather than inf.  Returned as a device
    array so the solver threads it through the jit as an ARGUMENT — a
    preconditioner closure capturing an n-vector would embed it as an
    HLO constant (module no-closure rule)."""
    import numpy as np
    m, n = A.shape
    md = min(m, n)
    nnz_m = int(A.row_ptr[m])
    rows = np.repeat(np.arange(m, dtype=np.int64), A.row_nnz)
    hit = A.col_idx[:nnz_m] == rows
    d = np.zeros(md, dtype=np.float64)
    d[rows[hit][rows[hit] < md]] = A.values[:nnz_m][hit][rows[hit] < md]
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    return jnp.asarray(inv, dtype or jnp.float32)


def cg(A, b, *, x0=None, tol: float = 1e-6, maxiter: int = 500,
       M=None, mesh=None) -> SolveResult:
    """Conjugate gradients for SPD A: one fused device loop.

    `A` as in `_matvec_of`; `M` is an optional preconditioner — either a
    traceable callable v -> M^-1 v, or an ARRAY holding the inverse
    diagonal (`jacobi_inv_diag`), which is threaded through the jit as
    an argument (an n-vector captured in a callable would embed as an
    HLO constant).
    Terminates when ||r|| <= tol * ||b|| or at `maxiter`."""
    b = jnp.asarray(b)
    matvec, operands, mkey = _matvec_of(A, mesh, b.dtype)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    m_arr = None
    if M is not None and not callable(M):
        m_arr = jnp.asarray(M, b.dtype)

    def run(ops_, b_, x_, m_):
        psolve = ((lambda v: v * m_) if m_ is not None
                  else (M if M is not None else (lambda v: v)))
        r = b_ - matvec(ops_, x_)
        z = psolve(r)
        p = r if M is None else z
        rz = jnp.vdot(r, z)
        b2 = jnp.vdot(b_, b_)
        tol2 = (tol * tol) * b2

        def cond(st):
            _, r_, _, _, it = st
            return (it < maxiter) & (jnp.vdot(r_, r_) > tol2)

        def body(st):
            x_c, r_c, p_c, rz_c, it = st
            Ap = matvec(ops_, p_c)
            alpha = rz_c / jnp.vdot(p_c, Ap)
            x_n = x_c + alpha * p_c
            r_n = r_c - alpha * Ap
            z_n = psolve(r_n)
            rz_n = jnp.vdot(r_n, z_n)
            p_n = z_n + (rz_n / rz_c) * p_c
            return x_n, r_n, p_n, rz_n, it + 1

        x_f, r_f, _, _, it = lax.while_loop(
            cond, body, (x_, r, p, rz, jnp.int32(0)))
        # tiny guard (not 1e-300: underflows to 0.0 in f32 -> 0/0 NaN on
        # b = 0, which solves exactly at it=0)
        rel = jnp.sqrt(jnp.vdot(r_f, r_f)
                       / jnp.maximum(b2, jnp.finfo(b_.dtype).tiny))
        return x_f, it, rel

    key = ("cg", mkey, tol, maxiter,
           M if callable(M) else (m_arr is not None))
    x, it, rel = _cached_jit(key, lambda: run)(operands, b, x0, m_arr)
    it, rel = int(it), float(rel)
    return SolveResult(x=x, iterations=it, residual=rel,
                       converged=rel <= tol * 1.0000001)


def bicgstab(A, b, *, x0=None, tol: float = 1e-6, maxiter: int = 500,
             mesh=None) -> SolveResult:
    """BiCGSTAB for general (nonsymmetric) A — the webbase-class
    matrices this framework targets are directed graphs, so CG's SPD
    requirement often fails; this is the standard Krylov fallback.
    Same fused single-dispatch loop and `A` forms as `cg`.

    Breakdown (rho or omega ~ 0) exits the loop with the current
    iterate; `converged` then reports honestly from the residual."""
    b = jnp.asarray(b)
    matvec, operands, mkey = _matvec_of(A, mesh, b.dtype)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    def run(ops_, b_, x_):
        r = b_ - matvec(ops_, x_)
        rhat = r  # shadow residual fixed at r0
        b2 = jnp.vdot(b_, b_)
        tol2 = (tol * tol) * b2
        # finfo.tiny, NOT a 1e-300 literal: the literal underflows to 0.0
        # in float32 and an exact mid-iteration convergence (t == 0)
        # would produce 0/0 = NaN omega
        eps = jnp.asarray(jnp.finfo(b_.dtype).tiny, b_.dtype)

        def cond(st):
            _, r_, _, _, _, _, _, it, alive = st
            return alive & (it < maxiter) & (jnp.vdot(r_, r_) > tol2)

        def body(st):
            x_c, r_c, p_c, v_c, rho_c, alpha_c, omega_c, it, _ = st
            rho_n = jnp.vdot(rhat, r_c)
            beta = (rho_n / rho_c) * (alpha_c / omega_c)
            p_n = r_c + beta * (p_c - omega_c * v_c)
            v_n = matvec(ops_, p_n)
            alpha = rho_n / jnp.vdot(rhat, v_n)
            s = r_c - alpha * v_n
            t = matvec(ops_, s)
            tt = jnp.vdot(t, t)
            omega_n = jnp.vdot(t, s) / jnp.maximum(tt, eps)
            x_n = x_c + alpha * p_n + omega_n * s
            r_n = s - omega_n * t
            alive = (jnp.abs(rho_n) > eps) & (jnp.abs(omega_n) > eps)
            return (x_n, r_n, p_n, v_n, rho_n, alpha, omega_n, it + 1,
                    alive)

        one = jnp.asarray(1.0, b_.dtype)
        zero = jnp.zeros_like(b_)
        x_f, r_f, *_, it, _ = lax.while_loop(
            cond, body,
            (x_, r, zero, zero, one, one, one, jnp.int32(0),
             jnp.asarray(True)))
        rel = jnp.sqrt(jnp.vdot(r_f, r_f)
                       / jnp.maximum(b2, jnp.finfo(b_.dtype).tiny))
        return x_f, it, rel

    x, it, rel = _cached_jit(("bicgstab", mkey, tol, maxiter),
                             lambda: run)(operands, b, x0)
    it, rel = int(it), float(rel)
    return SolveResult(x=x, iterations=it, residual=rel,
                       converged=rel <= tol * 1.0000001)


def pagerank(PT, n: int, *, dangling=None, damping: float = 0.85,
             tol: float = 1e-8, maxiter: int = 200, r0=None,
             mesh=None) -> SolveResult:
    """Power iteration on a column-stochastic transition matrix.

    `PT` is (a plan/shards/callable for) P^T, where edge i -> j
    contributes 1/outdeg(i) at (j, i); `dangling` is the {0,1} mask of
    zero-out-degree pages (their mass spreads uniformly).  Iterates
    r' = damping * (P^T r + dangling_mass / n) + (1 - damping)/n until
    the L1 change passes `tol` — all iterations inside one dispatch."""
    dtype = r0.dtype if r0 is not None else jnp.float32
    matvec, operands, mkey = _matvec_of(PT, mesh, dtype)
    r0 = (jnp.full(n, 1.0 / n, dtype) if r0 is None
          else jnp.asarray(r0))
    dang = (jnp.zeros(n, r0.dtype) if dangling is None
            else jnp.asarray(dangling, r0.dtype))
    a = damping

    def run(ops_, r_, dang_):
        # dang_ is an argument, not a capture: a captured n-vector would
        # embed as an HLO constant (the module's no-closure rule)
        def cond(st):
            _, delta, it = st
            return (it < maxiter) & (delta > tol)

        def body(st):
            r_c, _, it = st
            spread = matvec(ops_, r_c)
            mass = jnp.vdot(dang_, r_c)
            r_n = a * (spread + mass / n) + (1.0 - a) / n
            return r_n, jnp.abs(r_n - r_c).sum(), it + 1

        return lax.while_loop(
            cond, body, (r_, jnp.asarray(jnp.inf, r_.dtype), jnp.int32(0)))

    r, delta, it = _cached_jit(
        ("pagerank", mkey, n, damping, tol, maxiter),
        lambda: run)(operands, r0, dang)
    it, delta = int(it), float(delta)
    return SolveResult(x=r, iterations=it, residual=delta,
                       converged=delta <= tol)
