"""The benchmark's command: `python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`, from the root of a checkout.
Prints one JSON line (see `benchmark/README.md`); exits non-zero without
a CUDA card, without the port, or if JAX or the JAX package was
loaded."""

import time

T0 = time.perf_counter()  # set-up counts from the process's start

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.getcwd())

from rfdbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
