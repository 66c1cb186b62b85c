"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...`` from the root of the checkout).
"""

import os
import sys

if __name__ == "__main__":
    # Run as a script, the folder itself heads sys.path: the checkout's root
    # (the benchmark package and the program) goes first instead.
    _ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path[0] != _ROOT:
        sys.path.insert(0, _ROOT)
    from benchmark.harness import main

    sys.exit(main())
