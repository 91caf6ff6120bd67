"""Persistent XLA compilation cache, shared by every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at ``<checkout>/.jax_cache``
(listed in .gitignore): a fixed path, because the path is part of the
cache key. CPU runs without the variable keep no cache, because XLA:CPU
entries bake in the host's machine features.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir(platform: str, environ=os.environ) -> str | None:
    """Where the cache lives for `platform` under `environ` (None: off)."""
    if environ.get(ENV):
        return environ[ENV]
    if platform == "cpu":
        return None
    return CHECKOUT_CACHE


def enable_compile_cache() -> str | None:
    """Turn the cache on for this process; returns its directory."""
    path = cache_dir(jax.default_backend())
    if path is not None and not os.environ.get(ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
