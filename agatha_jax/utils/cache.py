"""Persistent XLA compilation cache.

The reference compiles ahead of time with nvcc, so its timed window
never includes compilation (gasal_align.cu:219-236 brackets only the
kernel launch).  JAX compiles at first trace; the persistent cache lets
repeated CLI and benchmark runs skip it.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> str:
    """Where the cache lives.

    ``$JAX_COMPILATION_CACHE_DIR`` when set; otherwise one fixed path
    inside the checkout (``.cache/jax``, gitignored).  The path is part
    of the cache key, so it never depends on a temporary name, a
    process id or the time.
    """
    env = os.environ.get(ENV)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".cache", "jax")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory.

    JAX reads ``$JAX_COMPILATION_CACHE_DIR`` itself, so no directory is
    set in code then.
    """
    import jax

    path = cache_dir()
    if not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
