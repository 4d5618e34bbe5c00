"""Plan serialization: save/load round trip for every plan type."""

import numpy as np
import pytest

import jax.numpy as jnp

from sblas.containers import DenseVector
from sblas.io.generate import fem_banded_like, uniform_random
from sblas.io.plancache import load_plan, save_plan
from sblas.ops import make_plan, spmv
from sblas.ops.rspmv import RoutedPlan


@pytest.mark.parametrize("kind", ["dia", "bsr", "ell", "wcoo", "coo"])
def test_roundtrip_structured(tmp_path, kind):
    A = fem_banded_like(n=600, half_band=5, dtype=np.float64)
    plan = make_plan(A, dtype=jnp.float64, force=kind)
    p = tmp_path / f"{kind}.npz"
    save_plan(str(p), plan)
    plan2 = load_plan(str(p))
    assert type(plan2) is type(plan)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    a = spmv(plan, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values))
    b = spmv(plan2, jnp.asarray(x.values), 3.0, 4.0, jnp.asarray(y.values))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roundtrip_routed(tmp_path):
    A = uniform_random(2000, 70000, 3, seed=4)
    plan = RoutedPlan.from_csr(A, dtype=jnp.float64)
    p = tmp_path / "routed.npz"
    save_plan(str(p), plan)
    plan2 = load_plan(str(p))
    assert plan2.schedule == plan.schedule
    assert plan2.unrank_schedule == plan.unrank_schedule
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    a = spmv(plan, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values))
    b = spmv(plan2, jnp.asarray(x.values), 2.0, 3.0, jnp.asarray(y.values))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dtype_guard_rejects_canonicalization(tmp_path):
    """A plan whose stored dtype the current config cannot reproduce must
    fail loudly, not silently downcast (ADVICE r1)."""
    import json

    from sblas.utils.errors import FormatError

    A = fem_banded_like(n=300, half_band=4, dtype=np.float64)
    plan = make_plan(A, dtype=jnp.float64, force="ell")
    p = tmp_path / "guard.npz"
    save_plan(str(p), plan)
    # tamper the recorded intent: claim the values were float16 — the
    # loader must notice loaded-dtype != recorded-dtype and raise
    with np.load(str(p)) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs["__meta__"]).decode())
    key = next(k for k in meta["__dtypes__"] if meta["__dtypes__"][k]
               == "float64")
    meta["__dtypes__"][key] = "float16"
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    np.savez_compressed(str(p), **blobs)
    with pytest.raises(FormatError):
        load_plan(str(p))


def test_dtype_recorded(tmp_path):
    A = fem_banded_like(n=300, half_band=4, dtype=np.float64)
    plan = make_plan(A, dtype=jnp.float64, force="coo")
    p = tmp_path / "rec.npz"
    save_plan(str(p), plan)
    plan2 = load_plan(str(p))
    assert plan2.vals.dtype == plan.vals.dtype


def test_load_pre_dtype_record_files(tmp_path):
    """Files saved before the dtype record existed (round 1) still load."""
    import json

    A = fem_banded_like(n=300, half_band=4, dtype=np.float64)
    plan = make_plan(A, dtype=jnp.float64, force="ell")
    p = tmp_path / "old.npz"
    save_plan(str(p), plan)
    with np.load(str(p)) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs["__meta__"]).decode())
    meta.pop("__dtypes__")  # simulate a round-1 file
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    np.savez_compressed(str(p), **blobs)
    plan2 = load_plan(str(p))
    assert type(plan2) is type(plan)


# ---------------------------------------------------------------------------
# Distributed / UM containers: the plans that take
# seconds-to-minutes to build must round-trip, not rebuild per process.
# ---------------------------------------------------------------------------

def _spmv_oracle_check(run, A, alpha=3.0, beta=4.0):
    from sblas.ops.cpu_reference import spmv_cpu
    from sblas.parallel import sync_to_host
    from sblas.utils.verify import assert_equal
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = run(jnp.asarray(x.values), jnp.asarray(y.values))
    assert_equal(sync_to_host(got), spmv_cpu(A, x, alpha, beta, y))


@pytest.mark.parametrize("kind", ["ell", "coo"])
def test_roundtrip_row_plan_shards(tmp_path, kind):
    from sblas.parallel import (make_mesh, partition_row_plans,
                                    spmv_dist_planned)
    A = fem_banded_like(n=640, half_band=4, dtype=np.float64)
    shards = partition_row_plans(A, 8, dtype=jnp.float64, kind=kind)
    p = tmp_path / "rps.npz"
    save_plan(str(p), shards)
    shards2 = load_plan(str(p))
    assert type(shards2) is type(shards)
    assert shards2.kind == shards.kind
    mesh = make_mesh(8)
    _spmv_oracle_check(
        lambda x, y: spmv_dist_planned(shards2, x, 3.0, 4.0, y, mesh), A)


def test_roundtrip_routed_shards(tmp_path):
    from sblas.parallel import (make_mesh, partition_row_plans,
                                    spmv_dist_planned)
    A = uniform_random(512, 512, 3, seed=5)
    shards = partition_row_plans(A, 8, dtype=jnp.float64, kind="routed")
    p = tmp_path / "routed_shards.npz"
    save_plan(str(p), shards)
    shards2 = load_plan(str(p))
    assert shards2.plan.schedule == shards.plan.schedule
    mesh = make_mesh(8)
    _spmv_oracle_check(
        lambda x, y: spmv_dist_planned(shards2, x, 3.0, 4.0, y, mesh,
                                       reduce="psum"), A)


def test_roundtrip_halo_dia_shards(tmp_path):
    from sblas.parallel import (make_mesh, partition_halo_dia,
                                    spmv_halo_planned)
    A = fem_banded_like(n=640, half_band=3, dtype=np.float64)
    shards = partition_halo_dia(A, 8, dtype=jnp.float64)
    p = tmp_path / "halo.npz"
    save_plan(str(p), shards)
    shards2 = load_plan(str(p))
    assert shards2.rows_per_shard == shards.rows_per_shard
    mesh = make_mesh(8)
    _spmv_oracle_check(
        lambda x, y: spmv_halo_planned(shards2, x, 3.0, 4.0, y, mesh), A)


def test_roundtrip_xfoot_shards(tmp_path):
    from sblas.io.generate import webbase_like
    from sblas.parallel import make_mesh, partition_xfoot, spmv_xfoot
    A = webbase_like(n=8_000, avg_deg=3.0, seed=6, local_scale=150.0,
                     dtype=np.float64)
    shards = partition_xfoot(A, 8, dtype=jnp.float64, kind="coo")
    p = tmp_path / "xfoot.npz"
    save_plan(str(p), shards)
    shards2 = load_plan(str(p))
    assert shards2.stats == shards.stats
    assert shards2.hot_total == shards.hot_total
    mesh = make_mesh(8)
    _spmv_oracle_check(
        lambda x, y: spmv_xfoot(shards2, x, 3.0, 4.0, y, mesh), A)


def test_roundtrip_host_resident_plan(tmp_path):
    import jax

    from sblas.memory import host_resident_plan, spmv_um
    from sblas.memory.host import _host_sharding
    A = fem_banded_like(n=512, half_band=4, dtype=np.float64)
    plan = host_resident_plan(A, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    p = tmp_path / "um.npz"
    save_plan(str(p), plan)
    plan2 = load_plan(str(p),
                      put=lambda a: jax.device_put(a, _host_sharding()))
    assert plan2.n_bands == plan.n_bands and plan2.kind == plan.kind
    assert not plan2.tuned  # residency state is transient by design
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    got = spmv_um(plan2, jnp.asarray(x.values), 3.0, 4.0,
                  jnp.asarray(y.values))
    from sblas.ops.cpu_reference import spmv_cpu
    from sblas.utils.verify import assert_equal
    assert_equal(np.asarray(got), spmv_cpu(A, x, 3.0, 4.0, y))


def test_roundtrip_host_resident_shards(tmp_path):
    from sblas.memory import host_resident_shards, spmv_um_dist
    from sblas.parallel import make_mesh
    A = uniform_random(512, 512, 3, seed=7)
    hs = host_resident_shards(A, 8, dtype=jnp.float64,
                              hbm_budget_bytes=64 << 10)
    p = tmp_path / "umsh.npz"
    save_plan(str(p), hs)
    hs2 = load_plan(str(p))
    assert hs2.n_bands == hs.n_bands and hs2.n_shards == hs.n_shards
    assert np.array_equal(hs2.offsets, hs.offsets)
    mesh = make_mesh(8)
    _spmv_oracle_check(
        lambda x, y: spmv_um_dist(hs2, x, 3.0, 4.0, y, mesh), A)


def test_schema_drift_raises_format_error(tmp_path):
    """A cache whose stored fields no longer match the plan dataclass
    surfaces FormatError (delete-and-rebuild guidance), not a raw
    TypeError — bench and CLIs key rebuild fallbacks on this."""
    import json

    from sblas.io.generate import fem_banded_like
    from sblas.io.plancache import load_plan, save_plan
    from sblas.ops import make_plan
    from sblas.utils.errors import FormatError

    A = fem_banded_like(n=256, half_band=4)
    p = make_plan(A, dtype=jnp.float64, force="coo")
    path = str(tmp_path / "p.npz")
    save_plan(path, p)
    # simulate drift: drop a required field's array from the archive
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    removed = next(k for k in data if k.startswith(("a:", "n:"))
                   and "__meta__" not in k)
    del data[removed]
    np.savez(path, **data)
    with pytest.raises(FormatError):
        load_plan(path)
