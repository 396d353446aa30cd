"""The port's benchmark, one cell a run:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with a CUDA card. It prints the
numbers it compares and their limits as its last lines on standard error,
and one JSON line as the last line of standard output. Without a card it
exits 2 and prints no result. The program's kernels are built into
``.portbench_cache/`` inside the checkout, so that only a checkout's first
run builds them.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
os.environ["APVT_TORCH_BUILD_DIR"] = os.path.join(ROOT, ".portbench_cache", "kernels")
os.environ["USE_FLAX"] = "0"  # a library that would load JAX by itself must not
# the package by its name from the root, not this folder's modules as top-level names
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (HERE, ROOT)]

from portbench.core import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T_START))
