#!/usr/bin/env python3
"""One run of one benchmark cell:

    python3 perfbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA card.  The program under test
is `src/repro_torch`; the cells are `BENCHMARK.json`'s.  Prints one JSON
line per run as its last line of standard output (see `harness`), and
exits non-zero without it when the card, the program or a cell is
missing.  Every build and kernel cache stays in `build/` inside the
checkout, at fixed paths, so that only a checkout's first run builds.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
# the checkout's root (for `perfbench`) and `src` (for the program), in
# place of this file's directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
