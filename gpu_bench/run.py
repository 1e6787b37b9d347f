"""Run one benchmark cell once and print its result line.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; everything the run builds or caches
stays inside it.
"""

import time

T0 = time.perf_counter()    # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed paths inside the checkout, so that
# only a cell's first run there builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".cache" / "gpu_bench" / sub)
sys.path[0] = str(ROOT)

from gpu_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t0=T0))
