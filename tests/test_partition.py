"""Partition planner tests: nnz balance, row straddling, padding, halo
metadata — the semantics of the reference's segment path
(matrix.h:356-395, 443-445) under adversarial distributions."""

import numpy as np
import pytest

from sblas.containers import CsrMatrix
from sblas.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random)
from sblas.partition import (partition_nnz_balanced, partition_report,
                                 partition_row_blocks)
from sblas.utils.errors import PartitionError


def _reassemble_dense(segs):
    """Sum every shard's (global-row) triplets — must equal the original
    matrix regardless of straddling, because mode 2 overlap-adds."""
    m, n = segs.shape
    out = np.zeros((m, n))
    rows = np.asarray(segs.rows)
    cols = np.asarray(segs.cols)
    vals = np.asarray(segs.vals)
    for s in range(segs.n_shards):
        np.add.at(out, (rows[s], cols[s]), vals[s])
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("gen", [
    lambda: uniform_random(100, 80, 5, seed=3),
    lambda: adversarial_skew(m=64, n=64, heavy_rows=1, heavy_nnz=200,
                             light_nnz=1),
])
def test_nnz_partition_reassembles(gen, n_shards):
    A = gen()
    segs = partition_nnz_balanced(A, n_shards, dtype=np.float64)
    np.testing.assert_allclose(_reassemble_dense(segs), A.to_dense())
    # padding rows must keep shards row-sorted for sorted segment_sum
    for s in range(n_shards):
        assert np.all(np.diff(np.asarray(segs.rows)[s]) >= 0)


def test_nnz_balance_ceil_rule():
    """avg = ceil(nnz/n) chunks, matching matrix.h:360."""
    A = uniform_random(50, 50, 4, seed=1)
    segs = partition_nnz_balanced(A, 3, dtype=np.float64)
    avg = -(-A.nnz // 3)
    rows = np.asarray(segs.rows)
    vals = np.asarray(segs.vals)
    real_counts = [(vals[s] != 0).sum() for s in range(3)]
    # duplicates of value exactly 0 don't exist in this generator, so real
    # nnz per shard is the chunk size
    assert real_counts[0] == avg and sum(real_counts) == A.nnz


def test_row_straddling_detected():
    """A single mega-row must straddle every shard boundary (the case the
    reference documents at matrix.h:443-445)."""
    A = adversarial_skew(m=32, n=32, heavy_rows=1, heavy_nnz=1000,
                         light_nnz=1)
    segs = partition_nnz_balanced(A, 4, dtype=np.float64)
    heavy = int(np.argmax(A.row_nnz))
    n_owning = sum(1 for s in range(4)
                   if segs.starting_rows[s] <= heavy <= segs.stopping_rows[s])
    assert n_owning >= 2  # straddles at least one boundary
    np.testing.assert_allclose(_reassemble_dense(segs), A.to_dense())


def test_more_shards_than_nnz():
    A = uniform_random(4, 4, 1, seed=2)
    segs = partition_nnz_balanced(A, 8, dtype=np.float64)
    np.testing.assert_allclose(_reassemble_dense(segs), A.to_dense())


def test_partition_report_smoke():
    A = uniform_random(20, 20, 3, seed=4)
    rep = partition_report(partition_nnz_balanced(A, 2, dtype=np.float64))
    assert "shard 0" in rep and "rows" in rep


def test_row_blocks_reassemble_and_halo():
    A = fem_banded_like(n=128, half_band=5)
    blocks = partition_row_blocks(A, 4, dtype=np.float64)
    m, n = blocks.shape
    out = np.zeros((m, n))
    r = blocks.rows_per_shard
    lrows = np.asarray(blocks.local_rows)
    cols = np.asarray(blocks.cols)
    vals = np.asarray(blocks.vals)
    for s in range(4):
        np.add.at(out, (lrows[s] + s * r, cols[s]), vals[s])
    np.testing.assert_allclose(out[:m], A.to_dense())
    assert blocks.halo_left <= 5 and blocks.halo_right <= 5


def test_row_blocks_requires_square():
    A = uniform_random(30, 20, 2, seed=5)
    with pytest.raises(PartitionError):
        partition_row_blocks(A, 2)
