"""The persistent compilation cache location (utils/compile_cache.py)."""

import os

import jax

from sblas.utils import compile_cache


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.compile_cache_dir() == os.path.join(root,
                                                             ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == os.path.join(
            root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            root, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
