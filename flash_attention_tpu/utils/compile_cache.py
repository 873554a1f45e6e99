"""The persistent XLA compilation cache, set in one place.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself);
otherwise the cache lives at ``<repo>/.jax_cache``, a fixed path so that
reruns from the same checkout hit it.
"""

from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
