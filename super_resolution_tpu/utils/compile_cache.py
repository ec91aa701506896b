"""Where the persistent XLA compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to ``.jax_cache/`` at the root of the
checkout (listed in ``.gitignore``): one fixed path, so that every run from
the checkout finds what earlier runs compiled.
"""

from __future__ import annotations

import os

import jax

__all__ = ["configure_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
