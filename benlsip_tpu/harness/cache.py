"""Location of JAX's persistent compilation cache.

The solver programs are large (nested while_loops over the whole TRALCNLLS
state machine) and compile in tens of seconds, so the benchmark and smoke
scripts keep compiled programs across processes.  The cache path is part
of the cache key, so it must not move between runs: it is the directory
named by `JAX_COMPILATION_CACHE_DIR` when that is set, and otherwise a
fixed directory inside the checkout (listed in `.gitignore`).

Tests keep the cache off (tests/conftest.py): they compile fresh programs
every session and gain nothing from it.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"
# Programs that compile faster than this are not worth a disk entry.
MIN_COMPILE_TIME_S = 1.0


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` if set, else the in-checkout default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `compile_cache_dir()`; returns it."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_TIME_S)
    return path
