"""Synthetic-proxy generators: the structure fingerprint used to validate
them against the real SuiteSparse files."""

import numpy as np
import pytest



def test_structure_stats_fingerprint():
    """The proxy-validation fingerprint reports the planner-relevant
    properties with sane values on the webbase proxy."""
    from sblas.io.generate import structure_stats, webbase_like
    W = webbase_like(n=20000, avg_deg=3.0, seed=5)
    st = structure_stats(W)
    assert st["shape"] == (20000, 20000)
    assert st["nnz"] == W.nnz
    assert 2.0 < st["avg_deg"] < 4.0
    assert st["row_deg_max"] >= st["row_deg_pct"][99.9]
    assert st["col_indeg_max"] >= 128  # Zipf hubs present
    assert st["hub_cols_ge128"] >= 1
    assert 0.0 < st["band_frac"][2048] <= 1.0
    assert st["band_frac"][64] <= st["band_frac"][2048]


def test_structure_stats_symmetry_sample():
    from sblas.io.generate import pattern_symmetric, structure_stats
    st = structure_stats(pattern_symmetric(n=200, nnz_target=900))
    assert st["sym_pattern_sample"] == 1.0


def test_compare_proxy_cli(tmp_path, capsys):
    import runpy
    import sys as _sys
    from sblas.io.generate import pattern_symmetric
    from sblas.io import mmio
    A = pattern_symmetric(n=60, nnz_target=200)
    coo = A.to_coo()
    p = str(tmp_path / "t.mtx")
    mmio.write_mtx(p, 60, 60, coo.row_idx, coo.col_idx, coo.values)
    import os
    cli = os.path.join(os.path.dirname(__file__), "..", "matrices",
                       "compare_proxy.py")
    argv = _sys.argv
    _sys.argv = ["compare_proxy.py", p]
    try:
        with pytest.raises(SystemExit) as e:
            runpy.run_path(cli, run_name="__main__")
        assert e.value.code == 0
    finally:
        _sys.argv = argv
    out = capsys.readouterr().out
    assert "nnz" in out and "bandwidth_pct" in out


def test_structure_stats_rectangular():
    """Rectangular matrices must not crash the fingerprint; symmetry is
    reported as undefined (review finding: col id could index row_ptr)."""
    from sblas.containers import CsrMatrix
    from sblas.io.generate import structure_stats
    rp = np.array([0, 1, 2], dtype=np.int64)
    ci = np.array([40, 3], dtype=np.int64)
    A = CsrMatrix(rp, ci, np.ones(2), (2, 50))
    st = structure_stats(A)
    assert st["shape"] == (2, 50)
    assert st["sym_pattern_sample"] is None
