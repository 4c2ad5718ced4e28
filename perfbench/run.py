"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's chips.  Every
build and kernel cache goes to a fixed directory under ``build/`` in the
checkout.  The run exits with another code than 0, and prints no result,
where the card or the program is missing or a check cannot be made."""

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHES = {"REPRO_TORCH_BUILD_DIR": "repro_torch_kernels",
          "TRITON_CACHE_DIR": "triton_cache",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor_cache",
          "CUDA_CACHE_PATH": "cuda_cache"}
for var, sub in CACHES.items():
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from perfbench.harness import cli
    sys.exit(cli.main(sys.argv[1:], T0))
