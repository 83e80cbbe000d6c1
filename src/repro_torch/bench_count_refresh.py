"""Simple Average's training time on one card with the EM boundary's count
refresh in its two exact forms: the dense scatter (the default) and the
reference's changed-token compaction with max(128, D·N/8) slots.

    PYTHONPATH=src python -m repro_torch.bench_count_refresh [--reps 3]

At the slice's configuration (`fig6_mdna`), at sweeps_per_launch 1 and 8.
The forms alternate dense, compacted, compacted, dense in each repeat;
each reading is the "train" span of one run (CUDA events).  An untimed
run first counts the delta refreshes (EM boundaries without a full
rebuild) and how many of them the compaction could take (the most tokens
any chain changed within the cap).  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess

import torch

from repro_torch import fig6_mdna
from repro_torch.core import ALGORITHMS, plan, types
from repro_torch.device import resolve_device
from repro_torch.timing import PhaseTimer


def _compacted(fits: list | None = None):
    def refresh(ntw, nt, tokens, mask, z_old, z_new):
        D, N = tokens.shape[-2:]
        cap = max(128, D * N // 8)
        if fits is not None:
            changed = (mask * (z_new != z_old)).reshape(-1, D * N) > 0
            fits.append(int(changed.sum(-1).max()) <= cap)
        return types.apply_count_deltas(ntw, nt, tokens, mask, z_old, z_new,
                                        cap=cap)
    return refresh


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args()
    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    train, test = fig6_mdna.make_data(a.seed, dev)
    forms = {"dense": types.apply_count_deltas, "compacted": _compacted()}
    out = {"card": card, "algorithm": "simple", "M": fig6_mdna.M}
    try:
        for spl in (1, 8):
            cfg = dataclasses.replace(fig6_mdna.CFG, sweeps_per_launch=spl)

            def train_ms(form):
                plan.apply_count_deltas = forms[form]
                timer = PhaseTimer(dev)
                ALGORITHMS["simple"](a.seed + 1, train, test, cfg,
                                     fig6_mdna.M, device=dev, timer=timer)
                return timer.ms()["train"]

            fits = []
            plan.apply_count_deltas = _compacted(fits)
            ALGORITHMS["simple"](a.seed + 1, train, test, cfg, fig6_mdna.M,
                                 device=dev)
            train_ms("dense")                                # warm-up
            ms = {"dense": [], "compacted": []}
            for _ in range(a.reps):
                for form in ("dense", "compacted", "compacted", "dense"):
                    ms[form].append(train_ms(form))
            out[f"spl{spl}"] = {
                "delta_refreshes": len(fits), "compaction_fits": sum(fits),
                **{f"{k}_train_ms": v for k, v in ms.items()},
                **{f"{k}_median_ms": statistics.median(v)
                   for k, v in ms.items()}}
    finally:
        plan.apply_count_deltas = types.apply_count_deltas
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
