"""One place that decides where JAX keeps its persistent compile cache.

Every entry point (the ``run_*`` CLIs, ``bench.py``, ``chip_smoke.py``
and the measuring scripts) calls :func:`configure_compile_cache` before
its first compile.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
already reads it and nothing is changed here.  Otherwise the cache goes
to the fixed path ``<checkout>/.jax_cache`` (listed in ``.gitignore``):
a fixed path, because the cache directory is part of the cache key and
a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at its one directory and
    return that directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
