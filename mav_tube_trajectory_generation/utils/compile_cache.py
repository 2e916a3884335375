"""Persistent XLA compilation cache placement, in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache goes to a fixed ``.jax_cache``
directory at the root of the checkout: the cache key includes nothing that
moves, so a fixed path is what lets a later process hit it.  Used by
``chip_smoke.py``, ``bench.py`` and ``examples/``.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: Root of the checkout this package lives in.
CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(root: str = CHECKOUT_ROOT) -> str:
    """The directory the compilation cache uses: the environment variable
    when it is set, else ``<root>/.jax_cache``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    return os.path.join(root, ".jax_cache")


def enable(root: str = CHECKOUT_ROOT) -> str:
    """Turn on the persistent compilation cache and return its directory.
    Call before the first compilation."""
    import jax
    d = cache_dir(root)
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
    return d
