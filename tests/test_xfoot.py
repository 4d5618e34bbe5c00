"""Footprint-compressed x-exchange SpMV (parallel/xfoot.py) vs the CPU
oracle on the virtual 8-device mesh — banded (halo-degenerate), skewed
web-like (hot hubs + cold tail), adversarial, and rectangular shapes."""

import jax.numpy as jnp
import numpy as np
import pytest

from sblas.config import SBlasConfig
from sblas.containers import DenseVector
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas.ops.cpu_reference import spmv_cpu
from sblas.parallel import (make_mesh, partition_xfoot, spmv_xfoot,
                                sync_to_host, xfoot_stats)
from sblas.utils.verify import assert_equal

N_DEV = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV)


def _check(A, mesh, **kw):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64, **kw)
    got = spmv_xfoot(shards, jnp.asarray(x.values), 3.0, 4.0,
                     jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 3.0, 4.0, y))
    return shards


def test_banded_degenerates_to_packets(mesh):
    A = fem_banded_like(n=1024, half_band=5, dtype=np.float64)
    shards = _check(A, mesh)
    # banded: halo-like adjacent packets, no hot broadcast
    assert shards.hot_total == 0
    assert shards.packet_pad > 0


def test_webbase_like_hot_plus_cold(mesh):
    A = webbase_like(n=20_000, avg_deg=3.0, seed=3, local_scale=200.0,
                     dtype=np.float64)
    shards = _check(A, mesh, kind="wcoo")
    st = shards.stats
    # hubs cluster at low ids -> a hot broadcast forms, and the exchange
    # moves far fewer bytes than the full vector (the psum_scatter cost)
    assert st.hot_total > 0
    assert st.comm_bytes(8) < A.shape[0] * 8


@pytest.mark.parametrize("engine", ["flat", "route"])
def test_extraction_engines_agree(mesh, engine):
    A = webbase_like(n=20_000, avg_deg=3.0, seed=5, local_scale=200.0,
                     dtype=np.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64, kind="coo",
                             extract=engine)
    assert shards.extract_mode == engine
    if engine == "route":
        assert shards.xroute_n > 0 and len(shards.xroute_tables) > 0
    else:
        assert shards.send_idx.shape[1] > 0
    got = spmv_xfoot(shards, jnp.asarray(x.values), 2.0, -1.0,
                     jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 2.0, -1.0, y))


def test_uniform_random(mesh):
    A = uniform_random(1024, 1024, nnz_per_row=4, seed=9, dtype=np.float64)
    _check(A, mesh)


def test_adversarial_skew(mesh):
    A = adversarial_skew(m=2048, n=2048, dtype=np.float64)
    _check(A, mesh)


def test_rectangular(mesh):
    A = uniform_random(1500, 700, nnz_per_row=3, seed=4, dtype=np.float64)
    _check(A, mesh)


def test_routed_kind(mesh):
    A = uniform_random(2048, 2048, nnz_per_row=3, seed=7,
                       dtype=np.float64)
    _check(A, mesh, kind="routed")


@pytest.mark.parametrize("kind", ["coo", "ell", "dia"])
def test_other_kinds(mesh, kind):
    A = fem_banded_like(n=512, half_band=3, dtype=np.float64)
    _check(A, mesh, kind=kind)


def test_alpha_beta_zero(mesh):
    A = uniform_random(512, 512, nnz_per_row=3, seed=11, dtype=np.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.random(A.height)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64)
    got = spmv_xfoot(shards, jnp.asarray(x.values), 1.0, 0.0,
                     jnp.asarray(y.values), mesh)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 1.0, 0.0, y))


def test_stats_cheap_and_consistent():
    A = webbase_like(n=20_000, avg_deg=3.0, seed=3, local_scale=200.0,
                     dtype=np.float64)
    st = xfoot_stats(A, N_DEV)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64, kind="coo")
    assert st == shards.stats
    assert st.comm_bytes(8) > 0
    # n=1: no exchange at all
    st1 = xfoot_stats(A, 1)
    assert st1.comm_bytes(8) == 0 and st1.hot_total == 0 \
        and st1.packet_pad == 0


def test_single_shard():
    from sblas.parallel import make_mesh as mm
    A = uniform_random(300, 300, nnz_per_row=3, seed=2, dtype=np.float64)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    mesh1 = mm(1)
    shards = partition_xfoot(A, 1, dtype=jnp.float64)
    got = spmv_xfoot(shards, jnp.asarray(x.values), 3.0, 4.0,
                     jnp.asarray(y.values), mesh1)
    assert_equal(sync_to_host(got), spmv_cpu(A, x, 3.0, 4.0, y))


def test_forced_hot_qmin_flat_oracle(mesh):
    """A forced hot_qmin > 2 demotes low-q hot columns into DUPLICATED
    packets; the flat extraction engine expresses that and stays
    oracle-correct, while the routed engine (a permutation network)
    must refuse rather than build a non-bijective map."""
    from sblas.utils.errors import PartitionError

    A = webbase_like(n=20_000, avg_deg=3.0, seed=3, local_scale=200.0,
                     dtype=np.float64)
    cfg = SBlasConfig(xfoot_hot_qmin=4)
    shards = _check(A, mesh, config=cfg)
    assert shards.stats.hot_qmin == 4
    base = _check(A, mesh)
    assert base.stats.hot_qmin == 2
    # demotion shrinks the hot set and grows the packets
    assert shards.hot_total < base.hot_total
    assert shards.packet_pad >= base.packet_pad
    with pytest.raises(PartitionError):
        partition_xfoot(A, N_DEV, dtype=jnp.float64, config=cfg,
                        extract="route")


def test_default_hot_qmin_keeps_route_bijective(mesh):
    """The default threshold (2) keeps q=1 packets + owner-unique hot —
    a bijection the routed extraction engine can express."""
    A = webbase_like(n=20_000, avg_deg=3.0, seed=5, local_scale=200.0,
                     dtype=np.float64)
    shards = _check(A, mesh, extract="route")
    assert shards.extract_mode == "route"
    assert shards.stats.hot_qmin == 2


def test_nocomm_twin_shapes_and_local_band(mesh):
    """The nocomm diagnostic keeps extraction + local compute and drops
    only the collectives: output shape matches the real run, and a
    BANDED matrix whose shard 0 happens to reference only its own block
    agrees exactly on that band (remote-dependent rows are timing-only
    garbage by contract)."""
    from sblas.parallel import spmv_xfoot_nocomm
    A = fem_banded_like(n=1024, half_band=5, dtype=np.float64)
    shards = partition_xfoot(A, N_DEV, dtype=jnp.float64)
    x = DenseVector.random(A.width)
    full = spmv_xfoot(shards, jnp.asarray(x.values), 1.0, 0.0,
                      jnp.zeros(A.height), mesh)
    nc = spmv_xfoot_nocomm(shards, jnp.asarray(x.values), mesh)
    assert nc.shape == full.shape
    # interior rows of shard 0 depend only on own-block x
    got = sync_to_host(nc)
    want = sync_to_host(full)
    interior = slice(8, shards.band_rows - 8)
    np.testing.assert_allclose(got[interior], want[interior])
