"""One run of one cell of the benchmark of dsptpu_torch on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line, the result, as the last line of stdout; exits
non-zero without a result if there is no CUDA card (or fewer than the
cell asks for), if the run fails, or if a JAX module was loaded. See
benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one process with few host threads
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# kernel caches at fixed paths inside the checkout (the port's own nvcc
# builds go to <checkout>/build/dsptpu_torch/<hash>/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "benchmark" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "benchmark"
                                         / "torch_extensions")
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
