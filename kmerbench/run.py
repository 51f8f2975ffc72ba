#!/usr/bin/env python3
"""The benchmark of hysortk_tpu_torch: one run of one cell.

    python3 kmerbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See kmerbench/harness.py.
"""

import os
import sys
import time

T0 = time.monotonic()  # set-up is timed from here, before any import
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from kmerbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))
