#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell:

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 .. \
        [--control-seeds 1 2 3] [--controls tf32 bfloat16]

For each seed of `--seeds`, a run's set-up and one fit of the program
against the plain reference (the lower readings); for each seed of
`--control-seeds` and each control, the reference computed in that
precision put in the program's place (the upper readings).  One JSON line
each, with the seconds the reference took.  The benchmark's own runs do
not run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=["tf32", "bfloat16"],
                    choices=["tf32", "bfloat16"])
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    harness.full_float32()
    spec = harness.read_spec()
    _, config, traffic, kind = harness.load_cell(spec, a.workload)
    dev = torch.device("cuda")
    readings = [(None, s) for s in a.seeds] + \
        [(c, s) for s in a.control_seeds for c in a.controls]
    for control, seed in readings:
        with kind.opened(config, traffic, seed, dev) as run:
            run.window(0.0001)
            t = time.perf_counter()
            gaps = run.checks(control)
            torch.cuda.synchronize()
            print(json.dumps({"workload": a.workload,
                              "reading": control or "program", "seed": seed,
                              **gaps,
                              "reference_s": time.perf_counter() - t,
                              "quality": run.quality()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
