"""Persistent XLA compilation cache.

The traversal/cluster/calling programs compile once per (n, chunk, flags)
shape family. JAX's persistent compilation cache carries those compiles
across processes, so it is enabled for every pipeline entry point.

Where the cache lives:

* ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other is set
  in code.
* unset: the fixed in-checkout path ``<repo>/.cache/xla`` (git-ignored).
  The path is part of the cache key, so it never depends on a temporary
  name, a process id or the time.
* unset under ``JAX_PLATFORMS=cpu``: no persistent cache. CPU compiles are
  fast, and serialising certain CPU executables for the cache write
  crashes the process (observed in jax's put_executable_and_time during
  the test suite).

The cache has no size bound or eviction; delete the directory to reclaim
space. ``enable()`` is called from the entry points (the pipeline run_*
functions) rather than at import time, so importing the package never
mutates global jax config.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".cache", "xla")

_DONE = False
_DIR: str | None = None


def cache_dir() -> str | None:
    """The directory the cache should use, or None for no persistent
    cache."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    if os.environ.get("JAX_PLATFORMS", "").lower() == "cpu":
        return None
    return DEFAULT_DIR


def enable() -> str | None:
    """Idempotently point jax at the persistent compilation cache; returns
    the directory in use (None when disabled)."""
    global _DONE, _DIR
    if _DONE:
        return _DIR
    _DONE = True
    d = cache_dir()
    if d is None:
        return None
    import jax

    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    # Cache every program: the pipeline's many medium-sized traversal /
    # cluster programs each cost a compile per process otherwise.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _DIR = d
    return d
