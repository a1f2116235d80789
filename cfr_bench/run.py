"""The benchmark's command: one run of one cell of BENCHMARK.json.

  python3 cfr_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The work is in harness.py; this file
only starts the clock and puts the checkout on the path (a spawned read
generator imports it again, so it imports nothing else at its top).
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from cfr_bench.harness import main
    sys.exit(main(sys.argv[1:], T0))
