#!/usr/bin/env python3
"""Run one cell of the benchmark (see BENCHMARK.json at the checkout's
root and benchmark/harness/main.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
