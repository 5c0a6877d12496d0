"""Where JAX keeps its persistent compilation cache.

One rule for every entry point: when ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is set in code; otherwise the cache
lives in a fixed directory inside the checkout (``.jax_cache/``,
git-ignored).  A fixed path matters: the path is part of what a cache
hit needs, so a directory that moves never hits.
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root: str) -> str:
    """The cache directory for a checkout rooted at ``root``."""
    return os.environ.get(ENV) or os.path.join(os.path.abspath(root),
                                               ".jax_cache")


def enable_compile_cache(root: str) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory."""
    path = compile_cache_dir(root)
    if not os.environ.get(ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
