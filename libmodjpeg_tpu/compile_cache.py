"""Where JAX keeps its persistent compilation cache.

Entry points (the CLI, the corpus runner, the benchmark and the device
smoke check) call ``use_compile_cache()`` once before their first compile,
so a short-lived process reuses what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX caches only programs that took longer than this to compile (its own
# default is 1 s).  Many of the stream's programs compile in less than a
# second each; a short-lived worker would re-pay all of them per process.
MIN_COMPILE_SECS = 0.1


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
    nothing here overrides it.  Otherwise the cache goes to
    ``<checkout>/.cache/jax``.  The path is part of what makes a cache hit,
    so it never depends on a temporary name, a process id or the time.
    Programs that compile in ``MIN_COMPILE_SECS`` or more are cached, unless
    ``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS`` says otherwise."""
    if not os.environ.get("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          MIN_COMPILE_SECS)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".cache", "jax")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
