"""The suite's platform: the CPU whatever JAX_PLATFORMS says, and the card
only for a run of the gpu-marked tests alone (tests/conftest.py)."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import conftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configure(markexpr):
    """conftest.pytest_configure on a stand-in config; returns the platforms
    it leaves, and puts the CPU back."""
    config = SimpleNamespace(option=SimpleNamespace(markexpr=markexpr),
                             addinivalue_line=lambda *a: None)
    try:
        conftest.pytest_configure(config)
        return jax.config.jax_platforms
    finally:
        jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("markexpr,want", [
    ("", "cpu"),
    ("not slow", "cpu"),
    ("not gpu", "cpu"),
    ("gpu or slow", "cpu"),
    ("gpu", conftest.GPU_PLATFORMS),
    (" gpu ", conftest.GPU_PLATFORMS),
])
def test_only_the_gpu_tests_alone_open_the_card(markexpr, want):
    assert _configure(markexpr) == want


def test_environment_platform_is_overridden():
    """A JAX_PLATFORMS the machine sets globally does not reach the suite:
    with a platform that cannot exist, a device test still runs on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="nosuchplatform")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly",
         "tests/test_compose_kernel.py::test_opaque_identity"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "1 passed" in r.stdout
