"""Persistent XLA compilation cache setup.

The cache lives where JAX_COMPILATION_CACHE_DIR says when it is set,
and otherwise at a fixed directory inside the checkout (``.jax_cache``
at the repository root, listed in .gitignore).  A fixed path matters:
the directory is part of what a later run must find again, so a path
that moves between runs never hits.  jax 0.9 needs the explicit
config.update calls (env vars alone don't enable every knob)."""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache")

_done = False


def cache_dir() -> str:
    """The directory the compile cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def setup_compilation_cache() -> None:
    global _done
    if _done:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _done = True
