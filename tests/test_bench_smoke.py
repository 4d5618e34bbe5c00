"""bench.py wiring smoke test.

The real bench runs on the GPU; a wiring bug in a rarely-exercised
branch (cache sidecar) would otherwise only surface there.  Patch the
workload generators down to toy sizes and run main() end to end on the
CPU mesh in a temp cwd — asserting the JSON line, the per-cell repeats,
and that the cache-sidecar path works both cold and warm."""

import io
import json
import sys

import numpy as np
import pytest


@pytest.fixture()
def tiny_bench(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # .bench_cache isolation
    import bench
    import sblas.io.generate as gen
    real_shell, real_web = gen.fem_shell_like, gen.webbase_like

    def small_shell(*a, **kw):
        kw.pop("nx", None), kw.pop("ny", None)
        return real_shell(nx=12, ny=6, dof=6, n_target=12 * 6 * 6,
                          dtype=kw.get("dtype", np.float32))

    def small_web(*a, **kw):
        return real_web(n=4096, avg_deg=3.0, seed=3, local_scale=60.0,
                        dtype=kw.get("dtype", np.float32))

    monkeypatch.setattr(gen, "fem_shell_like", small_shell)
    monkeypatch.setattr(gen, "webbase_like", small_web)
    # cheap timing: 2 loop iters, 1 rep
    import sblas.utils.benchtime as bt
    real_loop = bt.loop_time_ms

    def fast_loop(step, carry, iters=2, reps=1, args=()):
        return real_loop(step, carry, iters=2, reps=1, args=args)

    monkeypatch.setattr(bt, "loop_time_ms", fast_loop)
    return bench


def _run(bench, capsys):
    rc = bench.main()
    cap = capsys.readouterr()
    assert rc == 0
    line = json.loads(cap.out.strip().splitlines()[-1])
    return line, cap.err


def test_bench_main_cold_and_warm(tiny_bench, capsys):
    line, err = _run(tiny_bench, capsys)
    assert line["metric"] == "ref_workloads_geomean_speedup"
    assert line["unit"] == "x" and line["value"] > 0
    # repeatability contract: three independent repeats per timed cell,
    # median canonical, spread recorded
    assert {"spmm_shell", "spmv_webbase", "spmm_webbase_wcoo",
            "xfoot_shard4", "xfoot_shard16",
            "spmv_weak_shard4"} <= set(line["repeats"])
    for r in line["repeats"].values():
        assert r["min_ms"] > 0 and r["median_ms"] >= r["min_ms"]
        assert r["spread"] >= 0
    # every cell reports on stderr, and no projection remains
    assert "spmm k64 shell" in err and "spmv webbase-1M-like" in err
    assert "xfoot[spmv] n=16" in err and "spmv weak shard n=4" in err
    assert "scorecard" not in err and "projection" not in err
    # warm pass: every cache (plans + W4 stats sidecar) must hit cleanly
    line2, err2 = _run(tiny_bench, capsys)
    assert line2["metric"] == line["metric"]
    assert "unusable" not in err2 and "stale" not in err2
