"""chip_smoke.py wiring on the CPU mesh.

The script's real run is on the GPU at full size; here every phase runs
at toy size (generators patched down, few timed calls) so a wiring fault
fails on the CPU first.  Timings printed here are meaningless by design.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

_ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture()
def smoke(monkeypatch):
    import sblas.io.generate as gen
    real_web, real_shell = gen.webbase_like, gen.fem_shell_like

    def small_web(*a, **kw):
        return real_web(n=4096, avg_deg=3.0, seed=3, local_scale=60.0,
                        dtype=kw.get("dtype", np.float32))

    def small_shell(*a, **kw):
        return real_shell(nx=24, ny=12, dof=6, n_target=24 * 12 * 6,
                          dtype=kw.get("dtype", np.float32))

    monkeypatch.setattr(gen, "webbase_like", small_web)
    monkeypatch.setattr(gen, "fem_shell_like", small_shell)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.phase_device(require_gpu=False)
    mod.web, mod.shell = small_web(), small_shell()
    return mod


def test_main_refuses_without_gpu(smoke, capsys):
    """No GPU: exit non-zero and print no result line."""
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_phase_cli(smoke, tmp_path, capsys):
    smoke.phase_cli(str(tmp_path))
    out = capsys.readouterr().out
    assert out.count("Validation = True") == 2
    assert "spmv_test ok" in out and "spmm_test ok" in out


def test_phase_kernels(smoke, capsys, monkeypatch):
    # device loop timing compiles two fori_loops per kind, which is slow
    # on the CPU backend; its wiring is covered by test_loop_ms
    monkeypatch.setattr(smoke, "loop_ms", lambda fn, X, Y, iters: 1.0)
    res = smoke.phase_kernels(smoke.web, smoke.shell, calls=2)
    assert set(res["spmv"]) >= {"wcoo", "coo", "routed", "cusparse",
                                "_pick"}
    assert set(res["spmm"]) >= {"dia", "bsr", "ell", "wcoo", "coo",
                                "cusparse", "_pick"}
    assert "routed" not in res["spmm"]
    out = capsys.readouterr().out
    assert out.count("of the best") == 4


def test_loop_ms(smoke):
    import jax.numpy as jnp
    X = jnp.ones(64, jnp.float32)
    ms = smoke.loop_ms(lambda X_, Y_: 0.5 * Y_ + X_, X, jnp.zeros(64),
                       iters=4)
    assert ms > 0


def test_plan_bytes_flags_huge_layouts(smoke):
    """The buildability cap keeps a power-law matrix off DIA/BELL: their
    padded layouts scale with diagonals/blocks, not nnz."""
    from sblas.io.generate import webbase_like
    web = webbase_like()
    assert smoke.plan_bytes(web, "dia") > 50 * smoke.plan_bytes(web, "coo")
    assert smoke.plan_bytes(smoke.shell, "dia") < 1 << 20


def test_phase_um(smoke, capsys):
    smoke.phase_um(smoke.web, smoke.shell, budget=64 << 10)
    out = capsys.readouterr().out
    assert out.count("Validation = True") == 4


def test_phase_solver_and_f64(smoke, capsys):
    smoke.phase_solver(smoke.shell)
    smoke.phase_f64(smoke.web)
    out = capsys.readouterr().out
    assert "cg on SPD shell proxy" in out
    assert "f64 spmv" in out and "Validation = True" in out


def test_spd_system_is_spd(smoke):
    S = smoke.spd_system(smoke.shell)
    D = np.zeros(S.shape)
    coo = S.to_coo()
    D[coo.row_idx, coo.col_idx] = coo.values
    np.testing.assert_allclose(D, D.T)
    assert np.linalg.eigvalsh(D).min() > 0


def test_phase_multi(smoke, capsys):
    out = smoke.phase_multi(smoke.web, smoke.shell, 4, calls=2)
    assert {"spmm mode2 psum", "spmm mode2 psum_scatter",
            "spmv dist psum", "spmv dist psum_scatter",
            "spmv halo (shell)"} <= set(out)
    assert any(k.startswith("spmv xfoot") for k in out)
    assert any(k.startswith("spmv_um_dist") for k in out)
    assert any(k.startswith("spmm mode1") for k in out)
    text = capsys.readouterr().out
    assert "failed" not in text


def test_result_line_shape(smoke, capsys, monkeypatch):
    """main() ends with the one-line JSON result when the device check
    passes (forced here; the phases themselves are covered above)."""
    monkeypatch.setattr(smoke, "phase_device",
                        lambda: {"platform": "gpu", "kind": "k",
                                 "count": 1})
    monkeypatch.setattr(smoke, "phase_multi", lambda *a, **k: {})
    import jax
    monkeypatch.setattr(jax, "devices", lambda *a: [None] * 4)
    assert smoke.main(["--devices", "4"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "k", "count": 1}}
