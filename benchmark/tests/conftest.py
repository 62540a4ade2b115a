"""CPU tests of the benchmark's harness (``python -m pytest benchmark/tests``
from the root of the checkout).  Tests marked ``chip`` need an NVIDIA card
and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")
