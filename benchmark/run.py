#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the CUDA device:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (one JSON object); the numbers that decide ``correct`` are the last
lines of standard error.  It exits non-zero, printing no result, without
enough CUDA devices, or where the process holds JAX or the JAX package.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
