"""One benchmark run of commonroad_rp_tpu_torch on a CUDA card.

From the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints the compared numbers beside their limits on standard error and the
result as one JSON line on standard output.  It exits with another code
than 0 when no CUDA card is there.
"""

import os
import pathlib
import sys
import time

T_PROCESS = time.perf_counter()
BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

from benchlib.core import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_process=T_PROCESS))
