"""Experiment scripts: wiring smoke on the CPU mesh.

The scripts under `experiments/` are on-card measurements; an
ImportError, stale attribute, or cache-path bug in one of them would only
surface on the card and waste a run there.  Each main() runs end to end
here at toy scale in a temp cwd (so `.bench_cache` writes are isolated),
with the workload generators and the loop timer patched down — asserting
rc == 0 and that every script still speaks the current library API.
Numbers produced here are meaningless by design.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

_EXP = os.path.join(os.path.dirname(__file__), "..", "experiments")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"exp_{name}", os.path.join(_EXP, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def toy_world(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    import sblas.io.generate as gen
    real_web = gen.webbase_like

    def small_web(*a, **kw):
        return real_web(n=4096, avg_deg=3.0, seed=3, local_scale=60.0,
                        dtype=kw.get("dtype", np.float32))

    monkeypatch.setattr(gen, "webbase_like", small_web)
    import sblas.utils.benchtime as bt
    real_loop = bt.loop_time_ms

    def fast_loop(step, carry, iters=2, reps=1, args=()):
        return real_loop(step, carry, iters=2, reps=1, args=args)

    monkeypatch.setattr(bt, "loop_time_ms", fast_loop)
    # the sweep script mutates this env var; let pytest restore it
    monkeypatch.setenv("SBLAS_STREAM_CHUNK", "1")
    return monkeypatch


def test_shard_decompose(toy_world, capsys):
    mod = _load("shard_decompose")
    toy_world.setattr(sys, "argv", ["shard_decompose.py", "2"])
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert "mainroute" in out and "segsum" in out


def test_stream_chunk_sweep(toy_world, capsys):
    mod = _load("stream_chunk_sweep")
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert out.count("chunk=") == 4


def test_stress4m(toy_world, capsys):
    mod = _load("stress4m")
    assert mod.main() == 0
    out = capsys.readouterr().out
    assert "oracle[0:64] max_rel" in out and "routed SpMV" in out


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_trace_kinds(toy_world, tmp_path, op):
    """Every form of one workload is oracle-checked, traced and
    summarized (device lines differ on the CPU; the wiring is the
    point)."""
    import jax.numpy as jnp

    from sblas.containers import DenseMatrix, DenseVector
    from sblas.io.generate import fem_shell_like, webbase_like
    from sblas.ops.cpu_reference import spmm_cpu, spmv_cpu
    mod = _load("trace_kinds")
    if op == "spmv":
        A = webbase_like(dtype=np.float32)
        X = DenseVector.random(A.width, dtype=np.float32)
        Y = DenseVector.constant(A.height, 1.0, dtype=np.float32)
        want = spmv_cpu(A, X, 3.0, 4.0, Y)
        forms = {"wcoo", "coo", "routed", "coo_unsorted", "cusparse"}
    else:
        A = fem_shell_like(nx=24, ny=12, dof=6, n_target=24 * 12 * 6,
                           dtype=np.float32)
        X = DenseMatrix.random(A.width, 8, dtype=np.float32)
        Y = DenseMatrix.constant(A.height, 8, 1.0, dtype=np.float32)
        want = spmm_cpu(A, X, 3.0, 4.0, Y)
        forms = {"dia", "bsr", "ell", "wcoo", "coo", "wcoo_sorted",
                 "cusparse"}
    res = mod.trace_workload(op, A, jnp.asarray(X.values),
                             jnp.asarray(Y.values), want,
                             str(tmp_path / "traces"), calls=2)
    assert set(res) >= forms
    for r in res.values():
        assert r["span_us_per_call"] > 0 and 0.0 <= r["idle_share"] <= 1.0
