"""Tests of the benchmark. They run on the CPU at small sizes, except
those marked ``gpu``, which need a CUDA device, decide so inside the
test and skip without one:

    python -m pytest benchmark/tests -q           # here
    python -m pytest benchmark/tests -q -m gpu    # on the card
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one")
