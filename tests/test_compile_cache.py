"""The persistent compilation cache lands in one fixed directory."""

import os
import subprocess
import sys

import jax
import pytest

from libmodjpeg_tpu import compile_cache

PROBE = ("import jax, jax.numpy as jnp\n"
         "from libmodjpeg_tpu.compile_cache import use_compile_cache\n"
         "print(use_compile_cache())\n"
         "jax.jit(lambda x: x * 3 + 1)(jnp.arange(5)).block_until_ready()\n")


def _probe(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=compile_cache.CHECKOUT,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0", **env_extra)
    r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_env_var_set_wins(tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as given and entries land there."""
    where = str(tmp_path / "cc")
    assert _probe({"JAX_COMPILATION_CACHE_DIR": where}) == where
    assert any(n.startswith("jit_") for n in os.listdir(where))


def test_env_var_unset_uses_checkout(monkeypatch):
    """Without the variable the cache is <checkout>/.cache/jax."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.use_compile_cache()
        assert path == os.path.join(compile_cache.CHECKOUT, ".cache", "jax")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env,want", [
    (None, compile_cache.MIN_COMPILE_SECS),
    ("2.5", 2.5),
])
def test_min_compile_time(monkeypatch, env, want):
    """Programs from 0.1 s of compilation up are cached, unless the
    environment sets JAX's own minimum."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir or "unused")
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        if env is None:
            monkeypatch.delenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                               raising=False)
        else:
            monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS",
                               env)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              float(env))
        compile_cache.use_compile_cache()
        assert jax.config.jax_persistent_cache_min_compile_time_secs == want
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def test_same_path_across_calls_and_processes(monkeypatch):
    """No temporary name, process id or time in the path: two calls and two
    processes agree."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        first = compile_cache.use_compile_cache()
        assert compile_cache.use_compile_cache() == first
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert _probe({}) == first == _probe({})
    assert any(n.startswith("jit_") for n in os.listdir(first))
