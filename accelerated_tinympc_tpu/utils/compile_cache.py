"""Persistent compilation cache for the scripts that drive the solver.

Call :func:`enable_compile_cache` at the top of a script (``chip_smoke.py``,
``bench.py``, the examples) — never on library import. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache there and
nothing else is set here. Otherwise the cache lives at one fixed path inside
the checkout (``.jax_cache/``, listed in ``.gitignore``), so a later run of
the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
import pathlib

import jax

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
