"""JAX runtime initialization: persistent compilation cache.

Device programs here are shape-specialized (graph capacity, batch, ef), so
first-compile cost matters; the persistent cache makes warmup a one-time
cost per machine. Call init() before first device use (tests, bench, server
all do).
"""

from __future__ import annotations

import os

_DONE = False


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the cache key includes it, so a moving directory never
    hits)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".jax_cache")


def init() -> None:
    global _DONE
    if _DONE:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    _DONE = True
