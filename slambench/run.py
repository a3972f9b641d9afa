"""Run one cell of the benchmark on the card and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (see `slambench.harness`).
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
