"""Persistent XLA compilation cache for the entry points.

Every ``python -m fractal_tpu`` invocation is a fresh process; without a
persistent cache each one recompiles its kernels.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
changes it.  Otherwise the cache lives at one fixed path inside the
checkout (``.jax_cache``, listed in ``.gitignore``) — the path is part of
the cache's key, so it never moves.  Library importers are not affected —
only the entry points call this.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache")


def enable() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache everything that took real compile time
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
