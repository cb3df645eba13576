"""Run one cell of ``BENCHMARK.json`` once:

    python h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards. The
last line of standard output is the result (``core/harness.py``)."""

import time

T_START = time.perf_counter()  # set-up counts from the process's start

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100_bench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
