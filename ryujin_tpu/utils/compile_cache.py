"""Where JAX keeps its persistent compilation cache.

A run finds what an earlier run compiled only if both use the same
directory.  `JAX_COMPILATION_CACHE_DIR`, when set, names it and JAX reads
it itself;
otherwise the cache goes to one fixed directory inside the checkout
(listed in .gitignore).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Sets nothing when the variable is set."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    DEFAULT_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
