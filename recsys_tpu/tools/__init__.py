"""Measurement / protocol tools.

`enable_compile_cache` is shared by every entry point (bench.py,
chip_smoke.py, the CLI and the protocol runner), so the cache-dir policy
lives in exactly one place.
"""
from __future__ import annotations

import os

# fixed, so one checkout's processes find each other's compiles
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and
    no other directory is set here.  Otherwise the cache lives at the
    fixed ``<repo>/.jax_cache``.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return env_dir or REPO_CACHE_DIR
