"""Persistent XLA compilation cache shared by every entry point."""

from __future__ import annotations

import os

import jax

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it
    and no other directory is set here.  Otherwise the cache lives at
    the fixed path ``<repo>/.jax_cache``: the path is part of the cache
    key, so it never depends on a process, a time or a temporary name.
    """
    path = os.environ.get(ENV)
    if not path:
        path = os.path.join(REPO, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
