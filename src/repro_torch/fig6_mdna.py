"""Paper Figure 6 — MD&A / earnings-per-share — at the paper's dimensions.

The port's slice configuration: the reference's `benchmarks/fig6_mdna.py`
harness at scale 1.0 (Section IV-A1): 4216 documents (3000 train / 1216
test), W = 4238, T = 16, log-normal lengths with max 120, ρ = 0.25,
30 EM iterations, M = 4 chains, 15 + 10 prediction sweeps, defaults
otherwise.  The corpus is drawn by the port's `make_slda_corpus` from
`seed`; the algorithms run from `seed + 1`.

    PYTHONPATH=src python -m repro_torch.fig6_mdna --device cpu \
        [--sweeps-per-launch 8] [--sampler-mode sparse] \
        [--sparse-topic-cap 32]

prints each algorithm's test MSE beside var(y_test) and the ratios the
paper's claims rest on.  `--sweeps-per-launch 8` trains with fused
launches of 8 sweeps (kernel B3 on the card), as the reference's own
training benchmarks do; the default 1 trains one sweep per launch.
`--sampler-mode sparse` draws every topic through the sparse two-stage
draw over each word's top `--sparse-topic-cap` topics (clamped to T).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.core import ALGORITHMS, SLDAConfig
from repro_torch.data import make_slda_corpus, train_test_split
from repro_torch.timing import PhaseTimer

M = 4                     # the paper's worker count
N_DOCS, N_TRAIN, VOCAB, N_TOPICS, DOC_LEN = 4216, 3000, 4238, 16, 120
CFG = SLDAConfig(n_topics=N_TOPICS, vocab_size=VOCAB, rho=0.25, n_iters=30,
                 label_type="continuous")


def make_data(seed: int, device):
    corpus, _ = make_slda_corpus(seed, N_DOCS, VOCAB, N_TOPICS, DOC_LEN,
                                 rho=0.25, doc_len_dist="lognormal",
                                 device=device)
    return train_test_split(corpus, N_TRAIN)


def run(seed: int = 0, device="cuda", data=None, cfg=CFG) -> dict:
    """All four algorithms once under `cfg` (the slice's CFG, or a
    variant of it).  Returns {"var_y_test", "padding_frac",
    "algorithms": {name: {"test_mse", "phase_ms"}}, "ratios"}."""
    train, test = data if data is not None else make_data(seed, device)
    var_y = float(test.y.var(unbiased=False))
    rows = {}
    for name, fn in ALGORITHMS.items():
        timer = PhaseTimer(device)
        args = (seed + 1, train, test, cfg) + (() if name == "nonparallel"
                                               else (M,))
        yhat = fn(*args, device=device, timer=timer)
        rows[name] = {"test_mse": float(((yhat - test.y) ** 2).mean()),
                      "phase_ms": timer.ms()}
    mse = {k: v["test_mse"] for k, v in rows.items()}
    return {
        "var_y_test": var_y,
        "padding_frac": 1.0 - float(torch.cat([train.mask, test.mask])
                                    .mean()),
        "algorithms": rows,
        "ratios": {"naive/simple": mse["naive"] / mse["simple"],
                   "simple/nonparallel": mse["simple"] / mse["nonparallel"],
                   "weighted/nonparallel":
                       mse["weighted"] / mse["nonparallel"]},
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweeps-per-launch", type=int, default=1)
    ap.add_argument("--sampler-mode", choices=("dense", "sparse"),
                    default="dense")
    ap.add_argument("--sparse-topic-cap", type=int,
                    default=CFG.sparse_topic_cap)
    a = ap.parse_args()
    cfg = dataclasses.replace(CFG, sweeps_per_launch=a.sweeps_per_launch,
                              sampler_mode=a.sampler_mode,
                              sparse_topic_cap=a.sparse_topic_cap)
    print(json.dumps({"device": a.device, "seed": a.seed,
                      "sweeps_per_launch": a.sweeps_per_launch,
                      "sampler_mode": a.sampler_mode,
                      "sparse_topic_cap": a.sparse_topic_cap,
                      **run(a.seed, a.device, cfg=cfg)}))
