"""JAX persistent compilation cache location.

One directory per checkout, never derived from a temp name, a pid or the
time: the path is part of the cache key, so a moving directory never hits.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable() -> str:
    """Turn the persistent compile cache on and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    nothing is set in code; otherwise the cache lives at ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
