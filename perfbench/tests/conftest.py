"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the root of the checkout (CPU), and on a card machine with ``-m cuda``."""

import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
for p in (str(PERFBENCH.parent), str(PERFBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (decided in the "
        "`card` fixture)")
