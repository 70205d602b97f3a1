"""Persistent JAX compilation cache placement for the scripts that time
the card (chip_smoke.py, bench.py).

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins:
nothing here touches it.  Otherwise the cache goes to ``.jax_cache`` in
the given checkout root — a fixed path, because the path is part of the
cache key, and a directory that moves never hits.
"""

from __future__ import annotations

import os


def enable(root: str) -> str | None:
    """Point JAX's persistent compile cache at ``<root>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set.  Returns the directory
    this call set, or None when the environment decides."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
