"""JAX's persistent compilation cache, placed the same way everywhere.

`configure()` is called by the CLI, `bench.py` and `chip_smoke.py`
before their first compilation. If `JAX_COMPILATION_CACHE_DIR` is set,
JAX reads it itself and nothing is set here. Otherwise the cache goes
to `<checkout>/.jax_cache` (listed in .gitignore): a fixed path, since
the path is part of the cache key and a moving directory never hits.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure() -> str:
    """Enable the persistent compile cache; returns the directory used."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
