"""Checks that only an NVIDIA GPU can run: the chip_smoke.py phases at
reduced sizes, the device against the CPU backend in one process.

Run them on a machine with the card:

    python -m pytest tests/test_gpu.py -m gpu

Only such a run opens the card (tests/conftest.py).  Elsewhere they skip.  ``python chip_smoke.py`` runs the same phases at
full size.
"""

import jax
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (python -m pytest tests/test_gpu.py "
                    "-m gpu)")


def test_library_on_gpu(gpu):
    chip_smoke.library_phase(gpu, jax.devices("cpu")[0])


def test_stream_on_gpu(gpu):
    chip_smoke.stream_phase(gpu, jax.devices("cpu")[0], n_free=8, n_rst=4,
                            batch=4)


def test_grid_on_gpu(gpu):
    chip_smoke.grid_phase(gpu, jax.devices("cpu")[0], width=2048,
                          height=1024)
