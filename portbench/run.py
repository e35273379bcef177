#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells, configurations, traffic mixes
and metrics are named in BENCHMARK.json; ``portbench/harness/main.py``
says what a run does.
"""

import os
import sys
import time

T0 = time.monotonic()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, not this folder, is where imports resolve
sys.path[0] = ROOT

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    main(sys.argv[1:], T0)
