"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py``, the test
suite) calls :func:`enable_compile_cache` once, before its first compile,
so repeated runs on the same machine reuse compiled programs.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# Fixed in-checkout location (listed in .gitignore): the path is part of
# the cache key, so a directory that moved between runs would never hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself, so nothing else is configured); otherwise point the cache at
    :data:`DEFAULT_CACHE_DIR`.  Returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_CACHE_DIR
