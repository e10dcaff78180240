"""Persistent XLA compile cache for the repository's entry points.

Library import never touches the cache; launchers (chip_smoke.py,
bench.py, the examples) call enable_compile_cache() once, before their
first compilation.  The directory is `$JAX_COMPILATION_CACHE_DIR` when
that is set, and otherwise one fixed, git-ignored directory inside the
checkout — a fixed path, because the path is part of what a cached
entry is found by.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE_DIR = str(
    pathlib.Path(__file__).resolve().parents[2] / ".jax_compile_cache")


def compile_cache_dir() -> str:
    """The directory enable_compile_cache() uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return that directory."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
