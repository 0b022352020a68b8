"""Persistent XLA compilation cache setup.

The engines compile one executable per (penalties, K, B, L_pad) bucket;
shapes are normalized to a short ladder so the set is small, and this
cache makes them survive process restarts.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this
  module sets no directory;
* otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``). The path is part of the cache's key, so it
  must never be temporary, per-process or time-based.
"""

from __future__ import annotations

import os

#: fixed in-checkout default (the repository root holds the package)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache (idempotent). Call it
    before the first jit of any path."""
    global _enabled
    if _enabled:
        return
    _enabled = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        except OSError:
            return  # read-only checkout: run without a persistent cache
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
