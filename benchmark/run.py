#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the request pool from the seed, the configuration's keys loaded or
made under ``.keys/bench/``, one warm-up request), a closed loop of one client
for the window, the answers judged by the plain reference in ``refimpl/``,
then one JSON line on stdout. Progress and the numbers compared, each beside
its limit, go to stderr. Without enough CUDA devices it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One thread for the libraries' CPU side: the window's few CPU ops then wait
# on no thread pool that the host's other work has slowed.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START, root=HERE))
