"""Where JAX keeps its persistent compilation cache.

One helper that every entry point (``chip_smoke.py``, ``bench.py``, the
CLIs) calls before its first compile.  When ``JAX_COMPILATION_CACHE_DIR``
is set, JAX reads it itself and nothing here overrides it.  Otherwise the
cache goes to one fixed directory inside the checkout (listed in
``.gitignore``): the path is part of the cache key, so a fixed path is what
lets a later run find what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at the checkout's directory unless the
    environment already chose one; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
