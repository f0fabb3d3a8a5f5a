"""Entry point: python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See ``benchmark/harness.py`` and
``benchmark/README.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout's root, in place of this directory, so that the harness's
# modules are reached only as ``benchmark.*``
sys.path[:] = [os.path.dirname(HERE)] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
