"""The number policy: measured figures live in PERF.md and the ledger,
never in the README."""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_readme_carries_no_absolute_throughput():
    """Policy: README points at STATUS.md, it does not restate numbers."""
    import re

    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    found = {m.group(1) for m in re.finditer(r"(\d+(?:\.\d+)?)\s*MP/s",
                                             readme)}
    # "50" is the BASELINE target, not a measurement — that one may stay
    assert found <= {"50"}, \
        f"README must not carry measured MP/s figures, found {found}"
