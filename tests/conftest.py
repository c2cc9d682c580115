"""Test configuration.

Tests run on CPU with an 8-device virtual mesh so sharding logic is exercised
without accelerator hardware (SURVEY.md §4's multi-host test strategy).  Must
run before jax is imported anywhere.  Tests marked ``gpu`` need an NVIDIA GPU:
a run of those alone (``python -m pytest tests -m gpu``) lets the card in,
and their fixture skips them where there is none (tests/test_gpu.py).
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs on the CPU whatever JAX_PLATFORMS the environment sets;
# only a run of the gpu-marked tests alone opens the card (pytest_configure).
# Backends are not initialized until first use, so switching the platform
# in-process works.  XLA_FLAGS must be set before backend init to get the
# 8-device virtual CPU mesh for sharding tests.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
sys.path.insert(0, _REPO)
import jax

jax.config.update("jax_platforms", "cpu")
GPU_PLATFORMS = "cuda,cpu"  # the card, plus the CPU to compare against

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "/root/reference"
REFBUILD = os.path.join(REPO, ".refbuild")
# The repo's own committed fixture set (tests/fixtures/make_fixtures.py) —
# the core suite is self-contained; only oracle tests (marked ref_oracle)
# need the reference checkout, and those skip when it is absent.
FIXTURE_IMAGES = os.path.join(REPO, "tests", "fixtures")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "ref_oracle: needs the reference checkout (/root/reference) for "
        "differential oracles; auto-applied to tests using ref_tools")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere (run them alone with "
        "python -m pytest tests -m gpu)")
    if config.option.markexpr.strip() == "gpu":
        jax.config.update("jax_platforms", GPU_PLATFORMS)


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "ref_tools" in getattr(item, "fixturenames", ()):
            item.add_marker(pytest.mark.ref_oracle)


def _ensure_refbuild():
    """Build the reference modjpeg CLI + coefficient dump oracle (test-only)."""
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference checkout not present (oracle tests only)")
    modjpeg = os.path.join(REFBUILD, "modjpeg-dynamic")
    dump = os.path.join(REFBUILD, "dump_coefs")
    if not os.path.exists(modjpeg):
        os.makedirs(REFBUILD, exist_ok=True)
        subprocess.run(
            ["cmake", "-DCMAKE_BUILD_TYPE=Release", "/root/reference"],
            cwd=REFBUILD, check=True, capture_output=True)
        subprocess.run(["make"], cwd=REFBUILD, check=True, capture_output=True)
    if not os.path.exists(dump):
        subprocess.run(
            ["gcc", "-O2", os.path.join(REPO, "tools", "dump_coefs.c"),
             "-ljpeg", "-o", dump],
            check=True, capture_output=True)
    transcode = os.path.join(REFBUILD, "transcode_ref")
    if not os.path.exists(transcode):
        subprocess.run(
            ["gcc", "-O2", os.path.join(REPO, "tools", "transcode_ref.c"),
             "-ljpeg", "-o", transcode],
            check=True, capture_output=True)
    refcompose = os.path.join(REFBUILD, "ref_compose")
    if not os.path.exists(refcompose):
        subprocess.run(
            ["gcc", "-O2", "-I/root/reference/src",
             os.path.join(REPO, "tools", "ref_compose.c"),
             "-L" + REFBUILD, "-lmodjpeg", "-Wl,-rpath," + REFBUILD,
             "-o", refcompose],
            check=True, capture_output=True)
    dumpdropon = os.path.join(REFBUILD, "dump_dropon")
    if not os.path.exists(dumpdropon):
        subprocess.run(
            ["gcc", "-O2", "-I/root/reference/src",
             os.path.join(REPO, "tools", "dump_dropon.c"),
             "-L" + REFBUILD, "-lmodjpeg", "-Wl,-rpath," + REFBUILD,
             "-o", dumpdropon],
            check=True, capture_output=True)
    return modjpeg, dump


@pytest.fixture(scope="session")
def ref_tools():
    """(modjpeg_cli_path, dump_coefs_path) built from the reference sources."""
    return _ensure_refbuild()


@pytest.fixture(scope="session")
def fixture_jpeg():
    with open(os.path.join(FIXTURE_IMAGES, "image.jpg"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def fixture_dropon_png():
    with open(os.path.join(FIXTURE_IMAGES, "dropon.png"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def fixture_dropon_jpg():
    with open(os.path.join(FIXTURE_IMAGES, "dropon.jpg"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def fixture_mask_jpg():
    with open(os.path.join(FIXTURE_IMAGES, "mask.jpg"), "rb") as f:
        return f.read()
