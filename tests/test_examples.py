"""Example programs run end-to-end (CG solve on the SPD shell system)."""

import subprocess
import sys
import os


def test_cg_single():
    env = dict(os.environ)
    env["SBLAS_FORCE_CPU_DEVICES"] = "1"  # examples run on the CPU mesh
    r = subprocess.run(
        [sys.executable, "examples/cg.py", "--n", "3000", "--f64",
         "--tol", "1e-8"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Validation = True" in r.stdout


def test_cg_distributed():
    env = dict(os.environ)
    env["SBLAS_FORCE_CPU_DEVICES"] = "1"
    r = subprocess.run(
        [sys.executable, "examples/cg.py", "--n", "3000", "--f64",
         "--dist", "4", "--tol", "1e-8"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Validation = True" in r.stdout


def test_pagerank():
    env = dict(os.environ)
    env["SBLAS_FORCE_CPU_DEVICES"] = "1"
    r = subprocess.run(
        [sys.executable, "examples/pagerank.py", "--n", "20000",
         "--tol", "1e-7"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Validation = True" in r.stdout


def test_pagerank_dist():
    """Distributed PageRank: xfoot steady state (sharded ranks, footprint
    exchange only) on the virtual 8-device mesh."""
    env = dict(os.environ)
    env["SBLAS_FORCE_CPU_DEVICES"] = "1"
    r = subprocess.run(
        [sys.executable, "examples/pagerank_dist.py", "--n", "12000",
         "--tol", "1e-8"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Validation = True" in r.stdout
    assert "xfoot" in r.stdout
