"""Regression-pin make_plan's auto choices per structure class.

The classes are the plan-matrix experiment's (experiments/plan_matrix.py),
at full experiment size — the choice thresholds (blowup limits) are
scale-aware, so shrunken fixtures would pin different branches.  If a
heuristic changes deliberately, update the expectation HERE with the
measured justification.
"""

import jax.numpy as jnp
import pytest

from experiments.plan_matrix import _kind_of, matrix_classes
from sblas.ops import make_plan

# The ladder's picks.  Only the two reference workloads are measured on
# the H100 so far (webbase SpMV: wcoo best of the buildable kinds, routed
# 4.3x slower; full-size shell SpMM: ell best per call); the other
# classes pin the ladder until the plan matrix is re-run on the card.
EXPECTED = {
    # class: (spmv kind, spmm kind)
    "shell_fem": ("dia", "bsr"),
    "web_power": ("wcoo", "wcoo"),    # power-law web: the spmv headline
    "dense_band": ("bsr", "bsr"),
    "block_dom": ("bsr", "bsr"),
    "road_local": ("ell", "bsr"),
    "uniform": ("ell", "ell"),
    "rect_wide": ("ell", "ell"),
    "near_empty": ("coo", "coo"),     # ell is unprofitable on padded slots
    "skew_rows": ("wcoo", "wcoo"),
    "small_sym": ("dia", "bsr"),      # tiny: dense forms outright
}


@pytest.fixture(scope="module")
def matrices():
    return {name: gen() for name, gen in matrix_classes().items()}


@pytest.mark.parametrize("cname", sorted(EXPECTED))
def test_auto_choice(matrices, cname):
    A = matrices[cname]
    want_v, want_m = EXPECTED[cname]
    assert _kind_of(make_plan(A, dtype=jnp.float32, op="spmv")) == want_v
    assert _kind_of(make_plan(A, dtype=jnp.float32, op="spmm")) == want_m


def test_full_shell_spmm_prefers_dia():
    """The SpMM crossover away from BELL is SIZE-dependent (same
    structure, blowup 24) — guard the bench headline's full-scale
    choice.  On the H100 the lean form that wins per call is ELL (one-
    call device time ell 0.40 vs dia 0.50 ms), so ELL is picked where
    DIA used to be."""
    import numpy as np

    from sblas.io.generate import fem_shell_like
    A = fem_shell_like(dtype=np.float32)
    assert _kind_of(make_plan(A, dtype=jnp.float32, op="spmm")) == "ell"
