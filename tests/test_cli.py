"""CLI drivers end-to-end on the virtual CPU mesh (argv contract of the
reference binaries, spmm_test.cu:95-124 / spmv_test.cu:44-60)."""

import os

import numpy as np
import pytest

from sblas.io.mmio import write_mtx


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    """Small banded test matrix written as .mtx."""
    from sblas.io.generate import fem_banded_like
    A = fem_banded_like(n=300, half_band=4, dtype=np.float64)
    coo = A.to_coo()
    path = tmp_path_factory.mktemp("cli") / "band.mtx"
    write_mtx(str(path), A.height, A.width, coo.row_idx, coo.col_idx,
              coo.values)
    return str(path)


@pytest.mark.parametrize("method", ["1", "2", "2p", "halo"])
def test_spmm_cli(mtx_path, method, capsys):
    from sblas.cli.spmm_test import main
    rc = main([method, mtx_path, "8", "3.0", "4.0", "4", "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


@pytest.mark.parametrize("mode", ["dist", "distp", "halo", "halop",
                                  "xfoot", "hier", "single"])
def test_spmv_cli(mtx_path, mode, capsys):
    from sblas.cli.spmv_test import main
    rc = main([mtx_path, "3.0", "4.0", "4", "f64", "--mode", mode])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


def test_spmv_cli_transport_flag(mtx_path, capsys):
    """--transport parses and threads through plan construction (the
    banded fixture picks DIA, where the knob is inert; routed-engine
    bf16 semantics are covered in test_rspmv.TestBf16Transport)."""
    from sblas.cli.spmv_test import main
    rc = main([mtx_path, "3.0", "4.0", "1", "f32", "--mode", "single",
               "--transport", "bf16"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


def test_spmv_cli_progressive(mtx_path, capsys):
    """--progressive: a validated first result is
    served from the cheap plan BEFORE the final plan build, and the
    steady-state output is identical to the plain run."""
    from sblas.cli.spmv_test import main
    rc = main([mtx_path, "3.0", "4.0", "1", "f64", "--mode", "single",
               "--progressive"])
    out = capsys.readouterr().out
    assert rc == 0, out
    first = [ln for ln in out.splitlines() if ln.startswith("First result")]
    assert len(first) == 1 and "Validation = True" in first[0], out
    # first-result line precedes the steady-state validation verdict
    assert out.index("First result") < out.rindex("Validation = True")
    # steady state identical to the plain run (same nnz/s plan path)
    rc2 = main([mtx_path, "3.0", "4.0", "1", "f64", "--mode", "single"])
    out2 = capsys.readouterr().out
    assert rc2 == 0
    assert "First result" not in out2
    assert (out.split("max_abs")[-1].split()[0]
            == out2.split("max_abs")[-1].split()[0])


def test_spmv_cli_progressive_non_single_ignored(mtx_path, capsys):
    from sblas.cli.spmv_test import main
    rc = main([mtx_path, "3.0", "4.0", "4", "f64", "--mode", "dist",
               "--progressive"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "--progressive applies to --mode single only" in out
    assert "First result" not in out


def test_spmm_um_cli(mtx_path, capsys):
    from sblas.cli.spmm_test_um import main
    rc = main(["2", mtx_path, "8", "3.0", "4.0", "1", "1", "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


def test_spmv_um_cli(mtx_path, capsys):
    from sblas.cli.spmv_test_um import main
    rc = main([mtx_path, "3.0", "4.0", "1", "0", "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


def test_unit_test_cli(capsys):
    from sblas.cli.unit_test import main
    rc = main([])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "False" not in out


def test_too_many_devices_is_a_usage_error(mtx_path, capsys, monkeypatch):
    """Asking for more devices than exist exits 2 with a message instead
    of silently running on fewer."""
    import jax

    from sblas.cli.spmv_test import main
    monkeypatch.delenv("SBLAS_FORCE_CPU_DEVICES", raising=False)
    n = len(jax.devices()) + 1
    with pytest.raises(SystemExit) as e:
        main([mtx_path, "1.0", "1.0", str(n)])
    assert e.value.code == 2
    assert f"requested {n} devices" in capsys.readouterr().err


def test_validation_failure_exit_code(mtx_path, capsys):
    """Unlike the reference (unit_test.cu:177-187 returns 0 always), a
    failed validation must flip the exit code — simulate by corrupting
    tolerance via env."""
    from sblas.cli.common import finish
    assert finish(False, {}) == 1
    capsys.readouterr()


@pytest.fixture(scope="module")
def web_mtx_path(tmp_path_factory):
    """Small unstructured power-law matrix written as .mtx — the class of
    the reference's UM headline workload (webbase-1M, profiling.sh:16)."""
    from sblas.io.generate import webbase_like
    A = webbase_like(n=4000, avg_deg=3.0, seed=12, local_scale=100.0)
    coo = A.to_coo()
    path = tmp_path_factory.mktemp("cli") / "web.mtx"
    write_mtx(str(path), A.height, A.width, coo.row_idx, coo.col_idx,
              coo.values)
    return str(path)


@pytest.mark.parametrize("method", ["1", "2"])
@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmm_um_cli_multidevice(mtx_path, method, tuning, capsys):
    from sblas.cli.spmm_test_um import main
    rc = main([method, mtx_path, "8", "3.0", "4.0", "4", tuning, "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out
    assert "4 device(s)" in out


@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmv_um_cli_multidevice(mtx_path, tuning, capsys):
    from sblas.cli.spmv_test_um import main
    rc = main([mtx_path, "3.0", "4.0", "4", tuning, "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out


@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmv_um_cli_unstructured_budget(web_mtx_path, tuning, capsys,
                                         monkeypatch):
    """spmv_test_um passes on the
    webbase-class proxy with hbm_budget smaller than the matrix, both
    tuning modes, and reports nnz/s."""
    monkeypatch.setenv("SBLAS_HBM_BUDGET", str(64 << 10))
    from sblas.cli.spmv_test_um import main
    rc = main([web_mtx_path, "2.0", "3.0", "1", tuning, "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out
    assert "nnz/s" in out
    import re
    bands = int(re.search(r"(\d+) band", out).group(1))
    assert bands > 1


def test_comm_time_reported(mtx_path, capsys):
    """Distributed drivers report a comm/compute phase
    split (reference spmm.h:267-271 prints per-GPU NCCL time)."""
    from sblas.cli.spmm_test import main as spmm_main
    rc = spmm_main(["2", mtx_path, "8", "3.0", "4.0", "4", "f64"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Comm time (exposed psum)" in out
    assert "Compute time (per-shard)" in out
    from sblas.cli.spmv_test import main as spmv_main
    rc = spmv_main([mtx_path, "3.0", "4.0", "4", "f64", "--mode", "distp"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Comm time (exposed psum)" in out


def test_spmv_cli_plan_cache(mtx_path, tmp_path, capsys):
    """--plan-cache: first run builds and saves, second loads (FFTW-wisdom
    build-once/run-many)."""
    from sblas.cli.spmv_test import main
    cache = str(tmp_path / "distp.npz")
    rc = main([mtx_path, "3.0", "4.0", "4", "f64", "--mode", "distp",
               "--plan-cache", cache])
    out = capsys.readouterr().out
    assert rc == 0 and "plan cache: saved" in out and os.path.exists(cache)
    rc = main([mtx_path, "3.0", "4.0", "4", "f64", "--mode", "distp",
               "--plan-cache", cache])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "plan cache: loaded" in out
    assert "Validation = True" in out
