"""Persistent XLA compilation cache location.

The cache directory is part of JAX's cache key, so it must not move
between runs: `JAX_COMPILATION_CACHE_DIR` when set (JAX reads it
itself), else the fixed `<checkout>/.jax_cache` (listed in .gitignore).
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return the path.  Call before the first compilation."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
