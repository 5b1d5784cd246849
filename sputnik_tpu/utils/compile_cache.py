"""JAX's persistent compilation cache, in one place.

Scripts that compile large programs (``chip_smoke.py``, ``bench.py``,
``benchmarks/*``) call :func:`enable_compile_cache` once before compiling:

  * if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing;
  * otherwise the cache lives at ``<checkout>/.jax_cache`` — a fixed path
    inside the checkout (the path is part of the cache key, so a cache
    that moves never hits), listed in ``.gitignore``.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["enable_compile_cache", "default_cache_dir"]

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the directory above the package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = path or default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
