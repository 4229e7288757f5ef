"""Persistent XLA compilation cache for deployment entry points.

Per-instance ``jax.jit`` objects retrace per process, so every fresh
pipeline/server pays full XLA compiles of the fused frame programs.  JAX's
persistent compilation cache skips the XLA compile step across processes
AND across pipeline instances.

Opt-in by the entry points (benches, apps, server), not on library import:
the cache dir choice belongs to the app.
"""

from __future__ import annotations

import os

# Fixed in-checkout location (gitignored): the path is part of the cache
# key, so a directory that moved would never hit.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Enable the JAX persistent compilation cache on every backend.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set; otherwise the cache goes to :data:`DEFAULT_DIR`.
    Returns the cache dir.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    # default min-compile-time (1 s) keeps trivial programs out; the fused
    # frame/growth programs are all far above it
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
