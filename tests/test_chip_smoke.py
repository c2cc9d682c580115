"""chip_smoke.py without a GPU: it must refuse to run, and its phases must
work end to end when rehearsed on the CPU backend at tiny sizes."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
from jax.sharding import Mesh

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = dict(n_free=4, n_rst=2, batch=2, width=320, height=240,
              logo_wh=(64, 16))
GRID = dict(width=512, height=256, logo_wh=(64, 32))


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "device: JAX found cpu" in r.stderr


def test_library_phase_on_cpu():
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.library_phase(cpu, cpu)
    assert res["compose_vs_cpu"] == {"max_abs": 0, "share": 0.0,
                                     "n": res["compose_vs_cpu"]["n"]}
    assert res["write_modes_lossless"] == ["arithmetic", "baseline",
                                           "optimize", "progressive"]


def test_stream_phase_on_cpu():
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.stream_phase(cpu, cpu, **STREAM)
    assert res["splice_equals_full_bytes"] and res["surgical_equals_full_coefs"]
    assert res["footprint_vs_cpu_worst_file"]["max_abs"] <= 1
    assert res["watermark_calls_checked"] == 4


def test_grid_phase_on_cpu():
    cpu = jax.devices("cpu")[0]
    res = chip_smoke.grid_phase(cpu, cpu, **GRID)
    assert res["tables_equal_host_optimize"]
    assert res["compose_vs_cpu"]["max_abs"] == 0


def test_four_card_phases_on_virtual_cpu_devices():
    cpus = jax.devices("cpu")[:4]
    mesh = Mesh(np.asarray(cpus), ("batch",))
    res = chip_smoke.cards_stream_phase(mesh, cpus[0], **STREAM)
    assert all(res[k]["bytes_equal"] for k in ("splice", "full", "surgical"))
    grid = Mesh(np.asarray(cpus).reshape(1, 4), ("batch", "grid"))
    res = chip_smoke.cards_grid_phase(grid, cpus[0], **GRID)
    assert res["frame_equal"] and res["tables_equal"]


def test_check_rejects_footprint_drift():
    """The tolerance is enforced: +-2 anywhere, or +-1 on >0.5%, fails."""
    import pytest

    class Img:
        def __init__(self, coefs):
            self.coefs = coefs

    base = np.zeros((4, 4, 8, 8), np.int16)
    rects = [(0, 0, 4, 4)]
    off1 = base.copy()
    off1[0, 0, 0, 0] = 1                      # 1 of 1024: within bounds
    assert chip_smoke.compare_footprint(Img([off1]), Img([base]), rects,
                                        "t")["max_abs"] == 1
    off2 = base.copy()
    off2[0, 0, 0, 0] = 2
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.compare_footprint(Img([off2]), Img([base]), rects, "t")
    many = base.copy()
    many[0, :, 0, :] = 1                      # 32 of 1024 > 0.5%
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.compare_footprint(Img([many]), Img([base]), rects, "t")
