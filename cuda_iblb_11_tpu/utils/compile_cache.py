"""JAX's persistent compilation cache: one place decides where it lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache goes to ``.jax_cache`` at the root
of the checkout: a fixed path, because the path is part of the cache key
and a directory that moves never hits.  ``.gitignore`` lists it."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir(environ=os.environ) -> tuple[str, bool]:
    """(cache directory, whether it came from the environment)."""
    env = environ.get(ENV_VAR)
    if env:
        return env, True
    return DEFAULT_DIR, False


def configure_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory.
    Call before the first compilation."""
    import jax

    path, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
