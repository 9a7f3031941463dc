"""Persistent XLA compile cache at one fixed place.

``enable()`` is called once by every entry point (CLI, bench scripts,
chip_smoke.py) before the first compile.  If ``JAX_COMPILATION_CACHE_DIR``
is set, JAX already reads it and nothing is set here; otherwise the cache
lives in ``<checkout>/.jax_cache``.  The path is part of the cache key, so
it is never built from a temporary name, a process id or the time.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
