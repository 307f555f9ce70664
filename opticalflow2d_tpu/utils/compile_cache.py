"""Persistent compilation cache location.

Every (config, shape) pair compiles its own program
(``engine.registration._jitted_register``), and a cold process pays for
each one again. JAX's persistent cache keeps compiled programs on disk;
its key includes the cache path, so the path must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# The checkout root: the directory that holds the package.
_CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here. Otherwise the cache goes to ``.jax_cache/``
    at the checkout root (listed in ``.gitignore``).
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = os.path.join(_CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
