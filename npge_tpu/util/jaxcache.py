"""Persistent XLA compilation cache.

The pipeline's device ops compile once per (shape-bucket, k); the
persistent cache makes that a once-per-machine cost instead of
once-per-process (the orchestration loop itself never recompiles: shapes
are bucketed to powers of two and scalar arguments like T2 are traced, see
ops/extend.py). The cache key includes the backend and device kind, so
CPU and GPU executables share one directory safely.
"""

from __future__ import annotations

import os

# <checkout>/.jax_cache (listed in .gitignore): a fixed path, because the
# cache directory is part of what a warm run must find again
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Point JAX at the persistent compilation cache and return its
    directory. ``JAX_COMPILATION_CACHE_DIR``, when set, is used exactly as
    given (JAX reads it itself; no other directory is set in code);
    otherwise the cache lives in ``<checkout>/.jax_cache``. Call before the
    first jit dispatch for full effect."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
