"""Routed static permutations: edge coloring, layer programs, executors."""

import numpy as np
import pytest

import jax.numpy as jnp

from sblas.ops.route import (apply_route, apply_route_np, build_route,
                                 edge_color, routable_size,
                                 route_tables_device, _edge_color_py)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _regular_multigraph(rng, n_nodes, d):
    """d-regular bipartite multigraph: d stacked random perfect matchings."""
    src = np.repeat(np.arange(n_nodes), d)
    dst = np.concatenate([rng.permutation(n_nodes) for _ in range(d)])
    order = np.argsort(src, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.parametrize("n_nodes,d", [(4, 2), (16, 8), (100, 128)])
def test_edge_coloring_is_proper(rng, n_nodes, d):
    src, dst = _regular_multigraph(rng, n_nodes, d)
    colors = edge_color(src, dst, n_nodes, n_nodes, d)
    # proper: each (node, color) pair exactly once on both sides
    assert len(np.unique(src.astype(np.int64) * d + colors)) == n_nodes * d
    assert len(np.unique(dst.astype(np.int64) * d + colors)) == n_nodes * d
    assert colors.min() >= 0 and colors.max() < d


def test_python_fallback_matches_properties(rng):
    src, dst = _regular_multigraph(rng, 8, 4)
    colors = _edge_color_py(src, dst, 8, 8, 4)
    assert len(np.unique(src * 4 + colors)) == 32
    assert len(np.unique(dst * 4 + colors)) == 32


def test_routable_size():
    assert routable_size(1) == 128
    assert routable_size(128) == 128
    assert routable_size(129) == 256
    assert routable_size(3_600_000) == 4_194_304


@pytest.mark.parametrize("n", [5, 128, 300, 16384, 40000, 262144])
def test_route_numpy_executor(rng, n):
    perm = rng.permutation(n)
    prog = build_route(perm)
    x = rng.random(n).astype(np.float32)
    assert np.array_equal(apply_route_np(prog, x), x[perm])


@pytest.mark.parametrize("n", [128, 300, 16384, 50000])
def test_route_device_executor(rng, n):
    """Device executor (XLA row-local gathers) matches."""
    perm = rng.permutation(n)
    prog = build_route(perm)
    tables = route_tables_device(prog)
    x = rng.random(n).astype(np.float64)
    x_pad = jnp.asarray(np.pad(x, (0, prog.n - n)))
    got = np.asarray(apply_route(prog.schedule, x_pad, tables))[:n]
    assert np.array_equal(got, x[perm])


def test_route_identity_and_reversal(rng):
    n = 4096
    prog = build_route(np.arange(n))
    x = rng.random(n).astype(np.float32)
    assert np.array_equal(apply_route_np(prog, x), x)
    prog_r = build_route(np.arange(n)[::-1].copy())
    assert np.array_equal(apply_route_np(prog_r, x), x[::-1])


def test_fast_halve_coloring_is_proper(rng, monkeypatch):
    """The interleaved pairing-cycle walk (native fast path) normally only
    engages above ~1M edges; SBLAS_COLOR_FASTMIN=1 forces it for every
    group so its validity is CI-covered, including the phase-1 race and
    self-mirror serial fallbacks at small scale."""
    from sblas.io import native
    if not native.available():
        pytest.skip("native library unavailable")
    monkeypatch.setenv("SBLAS_COLOR_FASTMIN", "1")
    for n_nodes, d in [(4, 2), (37, 16), (100, 128), (513, 64)]:
        src, dst = _regular_multigraph(rng, n_nodes, d)
        colors = native.edge_color(src, dst, n_nodes, n_nodes, d)
        assert len(np.unique(src.astype(np.int64) * d + colors)) == n_nodes * d
        assert len(np.unique(dst.astype(np.int64) * d + colors)) == n_nodes * d
        assert colors.min() >= 0 and colors.max() < d


@pytest.mark.parametrize("n", [300, 16384, 40000])
def test_route_correct_under_forced_fast_halve(rng, n, monkeypatch):
    """End-to-end route built with the fast-path coloring forced on for
    every block still computes out[i] = in[perm[i]] (exercises the blocked
    entry point + fast_halve together)."""
    from sblas.io import native
    if not native.available():
        pytest.skip("native library unavailable")
    monkeypatch.setenv("SBLAS_COLOR_FASTMIN", "1")
    perm = rng.permutation(n)
    prog = build_route(perm)
    x = rng.random(n).astype(np.float32)
    assert np.array_equal(apply_route_np(prog, x), x[perm])


def test_edge_color_honors_no_native_env(monkeypatch):
    """SBLAS_NO_NATIVE=1 must route edge coloring through the pure-python
    path (ADVICE r1: route.py bypassed the kill switch)."""
    import numpy as np

    from sblas.io import native
    from sblas.ops.route import edge_color

    monkeypatch.setenv("SBLAS_NO_NATIVE", "1")
    assert not native.available()
    calls = []
    orig = native.edge_color

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(native, "edge_color", spy)
    rng = np.random.RandomState(0)
    d = 4
    # d-regular bipartite multigraph: d perfect matchings
    n = 16
    src = np.concatenate([np.arange(n, dtype=np.int32) for _ in range(d)])
    dst = np.concatenate([rng.permutation(n).astype(np.int32)
                          for _ in range(d)])
    colors = edge_color(src, dst, n, n, d)
    assert not calls, "native edge_color ran despite SBLAS_NO_NATIVE=1"
    # valid coloring: per (node, color) at most one edge on each side
    for side in (src, dst):
        assert len({(int(s), int(c)) for s, c in zip(side, colors)}) == len(src)


def test_native_level_matches_numpy_tables():
    """The fused native level builder (route.cpp::sblas_route_level) must
    emit byte-identical tables to the numpy formulation in rec() — both
    share the deterministic coloring core, so cached plans reproduce no
    matter which path built them."""
    import numpy as np
    import pytest

    from sblas.io import native
    from sblas.ops.route import build_route

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(3)
    for n in (128**2 * 3, 128**2 * 16):  # mix base case + deep level
        perm = rng.permutation(n).astype(np.int32)
        prog_native = build_route(perm)

        def raiser(*a, **k):
            raise RuntimeError("forced numpy path")

        orig = native.route_level
        native.route_level = raiser
        try:
            prog_numpy = build_route(perm)
        finally:
            native.route_level = orig
        assert len(prog_native.ops) == len(prog_numpy.ops)
        for a, b in zip(prog_native.ops, prog_numpy.ops):
            assert a[0] == b[0]
            if a[0] in ("gather", "mix"):
                assert np.array_equal(a[1], b[1])
            else:
                assert a[1:] == b[1:]
