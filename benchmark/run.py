"""Run one cell of the benchmark of nero_tpu_torch on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is `benchmark/workloads/<cell>.json`,
its configuration `benchmark/configs/<config>.json`, its scenes
`benchmark/scenes/<scene>.json`, the per-layer metrics
`benchmark/metrics/*.py`. Prints the result as the last line of standard
output (one JSON object) and each number that decided `correct` beside its
limit as the last lines of standard error. Exits non-zero, printing no
result, without a CUDA card or the program.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the program reads its databases under NERO_TPU_DATA_ROOT: the benchmark's
# photos go to a fixed directory of the checkout, written by its first run
os.environ["NERO_TPU_DATA_ROOT"] = os.path.join(ROOT, "build", "benchmark_data")

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
