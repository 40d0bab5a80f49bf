"""JAX's persistent compilation cache, in one place for every entry point.

The 1080p programs take tens of seconds to compile; the cache keeps them
across processes. Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
itself and nothing is set here. Otherwise the cache lives at the fixed
path `<checkout>/.jax_cache` (listed in .gitignore), so that later
processes in the same checkout reuse its entries.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the program's compile cache lives in."""
    return os.environ.get(ENV) or os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on (see module docstring); returns its
    directory."""
    import jax

    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
