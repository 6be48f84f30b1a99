"""JAX's persistent compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory; when
it is unset the cache lives at a fixed, git-ignored path inside the
checkout (``<repo>/.jax_cache``), so consecutive runs of the same checkout
hit it. Called by the benchmarks, ``chip_smoke.py``, the apps and the tests.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache", "DEFAULT_CACHE_DIR"]

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at the configured directory; returns it.
    Programs that compile faster than ``min_compile_secs`` are not cached."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
