"""Ops layer: single-chip SpMV/SpMM kernels + CPU oracle.

Analog of the reference's ops headers (spmm.h / spmv.h behind sblas.h).
Six device layouts, chosen by `make_plan`:

* DIA diagonal (shift-and-FMA) — banded structure, SpMV planning;
* Routed (gather/route/stack engine) — large unstructured, SpMV planning;
* BELL block-sparse (batched dense block matmuls) — block-friendly;
* ELL (gather + row sum) — balanced row occupancy;
* windowed COO (tiled gather + scatter-add) — unstructured;
* padded COO (gather + sorted segment_sum) — universal fallback.
"""

from . import cpu_reference  # noqa: F401
from .bsr import BsrPlan, bell_stats, spmm_bsr, spmv_bsr  # noqa: F401
from .dia import DiaPlan, dia_stats, spmm_dia, spmv_dia  # noqa: F401
from .elementwise import axpby, plus_scalar  # noqa: F401
from .plans import CooPlan, EllPlan  # noqa: F401
from .rspmv import RoutedPlan, spmv_routed  # noqa: F401
from .spmm import spmm_coo, spmm_ell  # noqa: F401
from .spmv import spmv_coo, spmv_ell  # noqa: F401
from .wcoo import WcooPlan, spmm_wcoo, spmv_wcoo  # noqa: F401

from ..config import DEFAULT

# The thresholds below were set from an earlier accelerator's plan matrix
# and have not been measured on the H100; they stay until the plan matrix
# (experiments/plan_matrix.py) is re-run on the card.

# Windowed-COO tile-split overhead beyond which plain COO is used instead
# (only near-empty matrices with huge row gaps get close).
_WCOO_FILL_LIMIT = 8.0

# SpMM-side BELL acceptance: dense blocks turn the product into batched
# dense matmuls, which beat every gather layout up to a large fill
# blowup.  The caps exclude near-empty structure (HBM-bound on padding)
# and multi-GB paddings.
_BSR_SPMM_BLOWUP_LIMIT = 512.0
_BSR_SPMM_BYTES_CAP = 1 << 30

# SpMM-side crossover from BELL to a lean form: BELL is HBM-bound on
# padded bytes, so a large padded BELL loses to ELL (balanced rows) or
# DIA while a small one wins.  On an H100 the shell proxy (465 MB of
# padded BELL, K=64) runs ell fastest, then dia, with bsr near 2x slower
# (chip_smoke.py phase c, wall median per call); the bound itself is
# unmeasured there.
_BSR_DIA_SPMM_BYTES = 256 << 20

# SpMV-side BELL-vs-DIA crossover: DIA SpMV is pass-count-bound (one
# sliced FMA per diagonal), BELL SpMV is HBM-bound on padded bytes — at
# low blowup BELL wins, at high blowup DIA wins.
_BSR_SPMV_BLOWUP = 8.0


def make_plan(A, dtype=None, config=DEFAULT, force=None, op=None):
    """Choose the best single-chip layout for CSR matrix `A`.

    Heuristics over ten structure classes x every feasible layout
    (experiments/plan_matrix.py — the role cuSPARSE's format-agnostic
    dispatch plays in the reference, spmm.h:146-149).  SpMV ladder: DIA
    (shift-and-FMA) when banded — except low-blowup BELL, which beats
    DIA's per-diagonal passes; then BELL / ELL / windowed-COO / COO.  The
    routed engine is never auto-chosen: on the H100 its SpMV on the
    webbase proxy is slower than windowed COO (chip_smoke.py phase c).
    SpMM / mixed ladder: BELL (batched dense block matmuls) whenever its
    padding fits the caps — ELL or DIA instead on banded structure once
    that padding is large — then DIA, ELL, windowed-COO, plain COO as
    the universal fallback.  Tiny (one-block) matrices go dense outright.  `force` in
    {"dia", "routed", "bsr", "ell", "wcoo", "coo"} overrides (routed is
    SpMV-only); `op` in {None, "spmv", "spmm"} biases the choice toward
    that kernel."""
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    kind = force
    if kind is None:
        m, n = A.shape
        bst = bell_stats(A, config.bsr_block)
        bsr_bytes = bst["blowup"] * max(A.nnz, 1) * jnp.dtype(dtype).itemsize
        if m <= config.bsr_block[0] and n <= config.bsr_block[1]:
            # tiny matrix (one block): the dense forms win outright —
            # blowup ratios are meaningless at kilobyte scale
            kind = "dia" if op == "spmv" else "bsr"
        elif op == "spmv":
            if DiaPlan.is_profitable(A, config):
                # low-blowup BELL beats DIA's per-diagonal passes
                # (see _BSR_SPMV_BLOWUP)
                kind = ("bsr" if bst["blowup"] <= _BSR_SPMV_BLOWUP
                        else "dia")
            elif bst["blowup"] <= config.bsr_blowup_limit:
                kind = "bsr"
            elif EllPlan.is_profitable(A, config):
                kind = "ell"
        else:  # spmm / mixed use
            if (bst["blowup"] <= _BSR_SPMM_BLOWUP_LIMIT
                    and bsr_bytes <= _BSR_SPMM_BYTES_CAP):
                # large padded BELL goes HBM-bound; on banded structure
                # (a lean DIA form exists) ELL, or else DIA, overtakes it
                # (see _BSR_DIA_SPMM_BYTES)
                kind = "bsr"
                if (bsr_bytes > _BSR_DIA_SPMM_BYTES
                        and DiaPlan.is_profitable(A, config)):
                    kind = ("ell" if EllPlan.is_profitable(A, config)
                            else "dia")
            elif DiaPlan.is_profitable(A, config):
                kind = "dia"
            elif EllPlan.is_profitable(A, config):
                kind = "ell"
        if kind is None:
            plan = WcooPlan.from_csr(A, dtype=dtype, config=config)
            if plan.fill_ratio <= _WCOO_FILL_LIMIT:
                return plan
            kind = "coo"
    if kind == "dia":
        return DiaPlan.from_csr(A, dtype=dtype, config=config)
    if kind == "routed":
        return RoutedPlan.from_csr(A, dtype=dtype, config=config)
    if kind == "bsr":
        return BsrPlan.from_csr(A, dtype=dtype, block=config.bsr_block,
                                config=config)
    if kind == "ell":
        return EllPlan.from_csr(A, dtype=dtype, config=config)
    if kind == "wcoo":
        return WcooPlan.from_csr(A, dtype=dtype, config=config)
    if kind == "coo":
        return CooPlan.from_csr(A, dtype=dtype, config=config)
    raise ValueError(f"unknown plan kind {kind!r}")


def make_plan_fast(A, dtype=None, config=DEFAULT):
    """Millisecond-build plan for progressive delivery: ELL when the row
    distribution allows it, COO otherwise — both are O(nnz) array
    reshuffles with no analysis phase.

    Serving the first call from this plan and hot-swapping to the
    `make_plan` result when its build (or cached load) completes bounds
    the time to a first validated result by the cheap build; plans are
    immutable pytrees, so the swap is a pointer exchange
    (cli/spmv_test.py --progressive)."""
    import jax.numpy as jnp
    dtype = dtype or jnp.float32
    if EllPlan.is_profitable(A, config):
        return EllPlan.from_csr(A, dtype=dtype, config=config)
    return CooPlan.from_csr(A, dtype=dtype, config=config)


def _plan_dtype(plan):
    """Value dtype of any plan kind (RoutedPlan stores values as gvals)."""
    return (plan.gvals if isinstance(plan, RoutedPlan)
            else plan.vals).dtype


def spmv(plan, x, alpha=1.0, beta=1.0, y=None):
    """y' = beta*y + alpha*A@x, dispatched on plan type (`y=None` drops the
    beta term)."""
    import jax.numpy as jnp

    from .spmv import spmv as _spmv_xla
    if y is None:
        y = jnp.zeros(plan.shape[0], dtype=_plan_dtype(plan))
        beta = 0.0
    if isinstance(plan, DiaPlan):
        return spmv_dia(plan, x, alpha, beta, y)
    if isinstance(plan, RoutedPlan):
        return spmv_routed(plan, x, alpha, beta, y)
    if isinstance(plan, BsrPlan):
        return spmv_bsr(plan, x, alpha, beta, y)
    if isinstance(plan, WcooPlan):
        return spmv_wcoo(plan, x, alpha, beta, y)
    return _spmv_xla(plan, x, alpha, beta, y)


def spmm(plan, B, alpha=1.0, beta=1.0, C=None):
    """C' = beta*C + alpha*A@B, dispatched on plan type (`C=None` drops the
    beta term)."""
    import jax.numpy as jnp

    from .spmm import spmm as _spmm_xla
    if isinstance(plan, RoutedPlan):
        raise TypeError(
            "RoutedPlan is SpMV-only (its contribution routing has no "
            "K-wide analog); build an SpMM plan with make_plan(A) or "
            "make_plan(A, op='spmm')")
    if C is None:
        C = jnp.zeros((plan.shape[0], B.shape[1]), dtype=_plan_dtype(plan))
        beta = 0.0
    if isinstance(plan, DiaPlan):
        return spmm_dia(plan, B, alpha, beta, C)
    if isinstance(plan, BsrPlan):
        return spmm_bsr(plan, B, alpha, beta, C)
    if isinstance(plan, WcooPlan):
        return spmm_wcoo(plan, B, alpha, beta, C)
    return _spmm_xla(plan, B, alpha, beta, C)
