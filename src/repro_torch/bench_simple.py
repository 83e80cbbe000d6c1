"""One Simple Average run's phase times on one card, repeated, and the
kernels that take its device time.

    PYTHONPATH=src python -m repro_torch.bench_simple [--topics 512]
        [--sweeps-per-launch 8] [--sampler-mode dense] [--reps 5]

On the slice's corpus (`fig6_mdna`) with `--topics` topics; the defaults
are `chip_smoke.py`'s `sparse_T512` phase, dense.  An untimed run first,
then `--reps` runs, each reading its "train" and "predict" spans (CUDA
events) and its wall time on the host's clock, then one run under
torch.profiler: the device time summed over its kernels, the share of
the wall time the device was idle, and the kernels that take the most.
It uses only `fig6_mdna`, `core.ALGORITHMS` and `timing.PhaseTimer`, so a
copy of this file in another checkout's package times that checkout.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from repro_torch import fig6_mdna
from repro_torch.core import ALGORITHMS
from repro_torch.timing import PhaseTimer


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--topics", type=int, default=512)
    ap.add_argument("--sweeps-per-launch", type=int, default=8)
    ap.add_argument("--sampler-mode", default="dense")
    ap.add_argument("--sparse-topic-cap", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    train, test = fig6_mdna.make_data(a.seed, dev)
    cfg = dataclasses.replace(
        fig6_mdna.CFG, n_topics=a.topics,
        sweeps_per_launch=a.sweeps_per_launch, sampler_mode=a.sampler_mode,
        sparse_topic_cap=a.sparse_topic_cap)

    def run(timer=None):
        kw = {} if timer is None else {"timer": timer}
        return ALGORITHMS["simple"](a.seed + 1, train, test, cfg,
                                    fig6_mdna.M, device=dev, **kw)

    run()                                                    # warm-up
    reps = []
    for _ in range(a.reps):
        timer = PhaseTimer(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yhat = run(timer)
        torch.cuda.synchronize()
        reps.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                     **{k: v for k, v in timer.ms().items()
                        if k in ("train", "predict")}})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and _device_us(e) > 0), key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    print(json.dumps({
        "bench": "simple", "label": a.label, "card": card,
        "topics": a.topics, "sweeps_per_launch": a.sweeps_per_launch,
        "sampler_mode": a.sampler_mode,
        "test_mse": float(((yhat - test.y) ** 2).mean()), "reps": reps,
        "profiled": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_idle_share": (1.0 - busy_ms / wall_ms
                                           if kernels else None),
                     "top_kernels": [{"name": e.key[:70], "calls": e.count,
                                      "ms": _device_us(e) / 1e3}
                                     for e in kernels[:10]]}}))


if __name__ == "__main__":
    main()
