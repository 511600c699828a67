"""The benchmark of tinsel_tpu_torch on an NVIDIA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md."""

import time

T_START = time.perf_counter()  # set-up is timed from the process's start

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the kernel caches of the run, at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / "_data" / "triton"))
os.environ["CUDA_CACHE_PATH"] = str(HERE / "_data" / "nv_compute_cache")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
