"""Routed SpMV engine: plan construction, correctness vs CPU oracle,
planning heuristics.  Sizes kept moderate — plan-time edge coloring is
O(nnz log 128)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.config import SBlasConfig
from sblas.containers import DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops import make_plan, spmv
from sblas.ops.cpu_reference import spmv_cpu
from sblas.ops.dia import DiaPlan
from sblas.ops.rspmv import RoutedPlan, spmv_routed
from sblas.utils.verify import assert_equal


def _check(A, alpha=3.0, beta=4.0):
    plan = RoutedPlan.from_csr(A, dtype=jnp.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_routed(plan, jnp.asarray(x.values), alpha, beta,
                      jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, alpha, beta, y))
    return plan


def test_powerlaw():
    plan = _check(webbase_like(n=60000, avg_deg=3.0))
    assert plan.stack_fill < 4.0


def test_uniform_wide():
    _check(uniform_random(2000, 100000, 4, seed=2))


def test_tall_narrow():
    _check(uniform_random(100000, 30000, 2, seed=5))


def test_adversarial_row_skew():
    """A handful of 2048-nnz rows among 2-nnz rows: the degree-sorted
    lane stack must stay correct (fill degrades, correctness must not)."""
    _check(adversarial_skew())


def test_alpha_beta_variants():
    A = uniform_random(5000, 70000, 3, seed=9)
    _check(A, alpha=1.0, beta=0.0)
    _check(A, alpha=-2.5, beta=1.5)


def test_make_plan_heuristic():
    """The routed engine is reachable by force= only: the auto ladder
    never picks it (it measured slower than windowed COO on the GPU)."""
    big = webbase_like(n=70000, avg_deg=4.0)
    plan = make_plan(big, op="spmv", dtype=jnp.float64, force="routed")
    assert isinstance(plan, RoutedPlan)
    assert not isinstance(make_plan(big, op="spmv"), RoutedPlan)
    # not for mixed / spmm use
    assert not isinstance(make_plan(big), RoutedPlan)
    # banded matrices keep the DIA path
    banded = fem_banded_like(n=2000, half_band=4)
    assert isinstance(make_plan(banded, op="spmv"), DiaPlan)


def test_dispatch_via_generic_spmv():
    A = webbase_like(n=70000, avg_deg=3.0)
    plan = make_plan(A, op="spmv", dtype=jnp.float64, force="routed")
    assert isinstance(plan, RoutedPlan)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv(plan, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))


@pytest.mark.parametrize("build", [
    ("single_dense_column",
     lambda rng, m: _dense_col(rng, m)),
    ("single_dense_row",
     lambda rng, m: _dense_row(rng, m)),
    ("one_nnz", lambda rng, m: _one_nnz(m)),
    ("empty", lambda rng, m: np.zeros((200, 300))),
    ("diagonal", lambda rng, m: np.diag(rng.rand(m) + 0.1)),
], ids=lambda b: b[0])
def test_degenerate_structures(build):
    """Routing stays correct on structures that break its fill
    assumptions (padding blows up, results must not)."""
    from sblas.containers import CsrMatrix
    rng = np.random.RandomState(0)
    m = 1500
    A = CsrMatrix.from_dense(build[1](rng, m))
    plan = RoutedPlan.from_csr(A, dtype=jnp.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_routed(plan, jnp.asarray(x.values), 3.0, 4.0,
                      jnp.asarray(y.values))
    assert_equal(np.asarray(got), spmv_cpu(A, x, 3.0, 4.0, y))


def _dense_col(rng, m):
    d = np.zeros((m, m))
    d[:, 7] = rng.rand(m) + 0.1
    return d


def _dense_row(rng, m):
    d = np.zeros((m, m))
    d[11, :] = rng.rand(m) + 0.1
    return d


def _one_nnz(m):
    d = np.zeros((m, m))
    d[5, 9] = 1.5
    return d


class TestHubPeel:
    """Hub-column peeling: in-degree skew must not inflate the gather
    tiling (web graphs have ~1e4-in-degree columns; without peeling one
    hub costs ceil(in_deg/128) near-empty 16384-slot tiles)."""

    def _hub_matrix(self, seed=9):
        rng = np.random.RandomState(seed)
        m = n = 4096
        rows_u = np.repeat(np.arange(m, dtype=np.int64), 2)
        cols_u = rng.randint(0, n, size=len(rows_u))
        hub_rows = rng.choice(m, size=2000, replace=False).astype(np.int64)
        rows = np.concatenate([rows_u, hub_rows])
        cols = np.concatenate([cols_u, np.full(2000, 7, dtype=np.int64)])
        vals = rng.random_sample(len(rows))
        from sblas.containers import CooMatrix
        return CooMatrix(rows, cols, vals, (m, n)).to_csr()

    def test_peel_engages_and_verifies(self):
        A = self._hub_matrix()
        plan = RoutedPlan.from_csr(A, dtype=jnp.float64)
        assert plan.n_prows >= 2000 // 128
        assert plan.gather_fill < 8.0
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values), 2.0, 3.0,
                          jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))

    def test_peel_disabled_matches(self):
        from sblas.config import SBlasConfig
        A = self._hub_matrix()
        cfg = SBlasConfig(routed_peel_threshold=0)
        plan = RoutedPlan.from_csr(A, dtype=jnp.float64, config=cfg)
        assert plan.n_prows == 0
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values), 2.0, 3.0,
                          jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))

    def test_all_peeled(self):
        """Every column a hub (single dense column repeated)."""
        from sblas.containers import CooMatrix
        m = 600
        rows = np.arange(m, dtype=np.int64)
        cols = np.full(m, 3, dtype=np.int64)
        vals = np.linspace(0.5, 1.5, m)
        A = CooMatrix(rows, cols, vals, (m, 512)).to_csr()
        from sblas.config import SBlasConfig
        cfg = SBlasConfig(routed_peel_threshold=16)
        plan = RoutedPlan.from_csr(A, dtype=jnp.float64, config=cfg)
        assert plan.n_prows == -(-m // 128)
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values), 1.0, 1.0,
                          jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 1.0, 1.0, y))


class TestStackCapSplit:
    """Heavy-row splitting (config.routed_stack_cap): a power-law head
    row must not set its whole 128-lane block's stack depth."""

    def _heavy_row_matrix(self, m=2048, n=4096, heavy=800, n_heavy=64,
                          seed=17):
        from sblas.containers import CooMatrix
        rng = np.random.RandomState(seed)
        hr = rng.choice(m, size=n_heavy, replace=False).astype(np.int64)
        rows = [np.repeat(hr, heavy),
                np.repeat(np.arange(m, dtype=np.int64), 2)]
        rows = np.concatenate(rows)
        cols = rng.randint(0, n, size=len(rows)).astype(np.int64)
        vals = rng.random_sample(len(rows))
        return CooMatrix(rows, cols, vals, (m, n)).to_csr()

    def test_split_engages_and_verifies(self):
        from sblas.config import SBlasConfig
        A = self._heavy_row_matrix()
        cfg = SBlasConfig(routed_stack_cap=128)
        plan = RoutedPlan.from_csr(A, dtype=jnp.float64, config=cfg)
        assert plan.merged
        # enough split slots to pack whole blocks: stack stays near
        # ceil-per-row instead of head-degree x blocks
        assert plan.stack_fill < 3.0
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values), 2.0, 3.0,
                          jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))

    def test_split_disabled_matches(self):
        from sblas.config import SBlasConfig
        A = self._heavy_row_matrix()
        cfg = SBlasConfig(routed_stack_cap=0)
        plan = RoutedPlan.from_csr(A, dtype=jnp.float64, config=cfg)
        assert not plan.merged
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values), 2.0, 3.0,
                          jnp.asarray(y.values))
        assert_equal(np.asarray(got), spmv_cpu(A, x, 2.0, 3.0, y))

    def test_cap_reduces_stack(self):
        from sblas.config import SBlasConfig
        A = self._heavy_row_matrix()
        p_cap = RoutedPlan.from_csr(
            A, dtype=jnp.float64, config=SBlasConfig(routed_stack_cap=256))
        p_flat = RoutedPlan.from_csr(
            A, dtype=jnp.float64, config=SBlasConfig(routed_stack_cap=0))
        assert p_cap.n_srows < p_flat.n_srows

    def test_distributed_split_shards(self):
        """Stacked shard plans stay schedule-equal with splitting on."""
        import jax
        from sblas.config import SBlasConfig
        from sblas.parallel import (make_mesh, partition_row_plans,
                                        spmv_dist_planned, sync_to_host)
        A = self._heavy_row_matrix(m=1024, n=1024)
        cfg = SBlasConfig(routed_stack_cap=64)
        shards = partition_row_plans(A, 8, dtype=jnp.float64,
                                     kind="routed", config=cfg)
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_dist_planned(shards, jnp.asarray(x.values), 3.0, 4.0,
                                jnp.asarray(y.values), make_mesh(8),
                                reduce="psum")
        assert_equal(sync_to_host(got), spmv_cpu(A, x, 3.0, 4.0, y))


class TestBf16Transport:
    """Opt-in bf16 route transport (config.routed_transport="bf16"):
    contributions form at f32, narrow only for the HBM-bound route
    passes, and upcast at the lane-stack reduce.  Per-contribution
    rounding is <= 2^-9 relative, so the oracle bar here is the
    documented reduced-precision one (1e-2 relative), with the typical
    error far below it."""

    def _mat(self):
        return webbase_like(n=50000, avg_deg=3.0, seed=31)

    def test_verifies_against_f64_oracle(self):
        A = self._mat()
        cfg = SBlasConfig(routed_transport="bf16")
        plan = RoutedPlan.from_csr(A, dtype=jnp.float32, config=cfg)
        assert plan.transport == "bf16"
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        got = spmv_routed(plan, jnp.asarray(x.values, jnp.float32), 2.0,
                          3.0, jnp.asarray(y.values, jnp.float32))
        want = spmv_cpu(A, x, 2.0, 3.0, y)
        assert_equal(np.asarray(got), want, error_bar=1e-2, relative=True)

    def test_f32_plan_unchanged_by_default(self):
        A = self._mat()
        plan = RoutedPlan.from_csr(A, dtype=jnp.float32)
        assert plan.transport == "f32"

    def test_rejects_non_f32_values(self):
        from sblas.utils.errors import PlanError
        cfg = SBlasConfig(routed_transport="bf16")
        with pytest.raises(PlanError):
            RoutedPlan.from_csr(self._mat(), dtype=jnp.float64, config=cfg)

    def test_rejects_unknown_transport(self):
        from sblas.utils.errors import PlanError
        cfg = SBlasConfig(routed_transport="f16")
        with pytest.raises(PlanError):
            RoutedPlan.from_csr(self._mat(), dtype=jnp.float32, config=cfg)

    def test_plancache_roundtrip_preserves_transport(self, tmp_path):
        from sblas.io.plancache import load_plan, save_plan
        A = self._mat()
        cfg = SBlasConfig(routed_transport="bf16")
        plan = RoutedPlan.from_csr(A, dtype=jnp.float32, config=cfg)
        p = str(tmp_path / "bf16_plan.npz")
        save_plan(p, plan)
        loaded = load_plan(p)
        assert loaded.transport == "bf16"
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        a = spmv_routed(plan, jnp.asarray(x.values, jnp.float32), 1.0, 0.0,
                        jnp.asarray(y.values, jnp.float32))
        b = spmv_routed(loaded, jnp.asarray(x.values, jnp.float32), 1.0,
                        0.0, jnp.asarray(y.values, jnp.float32))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_bf16_tables_are_int16(self):
        """The bf16 plan carries its MAIN route tables in int16, which
        halves the index-stream HBM traffic.  The unrank/x routes stay
        f32 and keep int32 tables."""
        cfg = SBlasConfig(routed_transport="bf16")
        plan = RoutedPlan.from_csr(self._mat(), dtype=jnp.float32,
                                   config=cfg)
        assert all(t.dtype == jnp.int16 for t in plan.tables)
        assert all(t.dtype == jnp.int32 for t in plan.unrank_tables)
        assert all(t.dtype == jnp.int32 for t in plan.xroute_tables)

    def test_with_transport_switches_both_ways(self):
        A = self._mat()
        plan32 = RoutedPlan.from_csr(A, dtype=jnp.float32)
        plan16 = plan32.with_transport("bf16")
        assert plan16.transport == "bf16"
        assert all(t.dtype == jnp.int16 for t in plan16.tables)
        back = plan16.with_transport("f32")
        assert back.transport == "f32"
        assert all(t.dtype == jnp.int32 for t in back.tables)
        assert plan32.with_transport("f32") is plan32
        x = DenseVector.random(A.width)
        y = DenseVector.constant(A.height, 1.0)
        xv = jnp.asarray(x.values, jnp.float32)
        yv = jnp.asarray(y.values, jnp.float32)
        # table re-widthing is value-preserving: f32->bf16->f32 output
        # matches the straight f32 plan exactly
        np.testing.assert_array_equal(
            np.asarray(spmv_routed(back, xv, 2.0, 3.0, yv)),
            np.asarray(spmv_routed(plan32, xv, 2.0, 3.0, yv)))
        # and the converted plan equals a natively-built bf16 plan
        cfg = SBlasConfig(routed_transport="bf16")
        native16 = RoutedPlan.from_csr(A, dtype=jnp.float32, config=cfg)
        np.testing.assert_array_equal(
            np.asarray(spmv_routed(plan16, xv, 2.0, 3.0, yv)),
            np.asarray(spmv_routed(native16, xv, 2.0, 3.0, yv)))

    def test_with_transport_rejects_f64(self):
        from sblas.utils.errors import PlanError
        plan = RoutedPlan.from_csr(self._mat(), dtype=jnp.float64)
        with pytest.raises(PlanError):
            plan.with_transport("bf16")
        with pytest.raises(PlanError):
            plan.with_transport("f16")


def test_shared_routed_sizes_appendix_alignment():
    """A deep-primary/no-overflow shard stacked with a shallow/overflow
    shard: padding the first's appendix to the shared slot count adds
    depth-1 pad blocks, so the naive max-S probe under-sizes the stack
    and the plans diverge (found by round-3 code review; reproduced as a
    ValueError in build_stacked_plans)."""
    from sblas.containers import CooMatrix
    from sblas.parallel.planned import build_stacked_plans
    from sblas.config import SBlasConfig
    rng = np.random.RandomState(4)
    n = 4096
    cfg = SBlasConfig(routed_stack_cap=256)

    def mk(rows, deg):
        r = np.repeat(np.arange(rows, dtype=np.int64), deg)
        c = rng.randint(0, n, size=len(r)).astype(np.int64)
        v = rng.random_sample(len(r))
        return CooMatrix(r, c, v, (256, n)).to_csr()

    deep = mk(256, 256)   # S=512, no overflow
    over = mk(100, 257)   # shallow primary, overflow appendix
    stacked, kind = build_stacked_plans([deep, over], "routed", 256, n,
                                        deep.nnz + over.nnz, jnp.float64,
                                        cfg)
    assert kind == "routed"
    # both shards now share one static stack depth
    assert stacked.brow_ids.shape[0] == 2  # leading shard axis


def test_spmv_default_y_routed():
    """spmv(plan, x) with y=None must work for RoutedPlan (its values
    live in gvals, not vals — the dispatcher crashed on plan.vals)."""
    A = webbase_like(n=50000, avg_deg=3.0, seed=13)
    plan = make_plan(A, op="spmv", dtype=jnp.float64, force="routed")
    assert isinstance(plan, RoutedPlan)
    x = DenseVector.random(A.width)
    got = spmv(plan, jnp.asarray(x.values))
    want = spmv_cpu(A, x, 1.0, 0.0,
                    DenseVector.constant(A.height, 0.0))
    assert_equal(np.asarray(got), want)
    # spmm on a RoutedPlan keeps the FRIENDLY error, reached before any
    # dtype probe
    import pytest as _pytest
    from sblas.ops import spmm as _spmm
    with _pytest.raises(TypeError):
        _spmm(plan, jnp.ones((A.width, 4)))
