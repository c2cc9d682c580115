"""bench.py measures the GPU path only: without a GPU it fails loudly."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())
    assert "JAX found cpu" in r.stderr
