#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ap_adapter_torch`` once, on the card
of the machine it is started on:

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``h100_bench/harness.py``."""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of compilers at fixed paths inside the checkout; no JAX through transformers
for key, value in (("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions")),
                   ("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton")),
                   ("USE_FLAX", "0"), ("USE_TF", "0"), ("OMP_NUM_THREADS", "4")):
    os.environ[key] = value
sys.path.insert(0, ROOT)

from h100_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
