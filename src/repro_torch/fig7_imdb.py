"""Paper Figure 7 — IMDB movie reviews / sentiment — at the paper's size.

The reference's `benchmarks/fig7_imdb.py` harness at scale 1.0 (Section
IV-A2): 25,000 documents (20,000 train / 5,000 test), W = 16,000 (the
harness's 8000·scale·2), T = 16, log-normal lengths with max 150,
ρ = 0.25, binary labels (the latent response thresholded at its
median), 30 EM iterations, M = 4 chains, 15 + 10 prediction sweeps,
defaults otherwise.  The metric is test accuracy (ŷ > 0.5 against
y > 0.5); Weighted Average weights each chain by its training accuracy.
The corpus is drawn by the port's `make_slda_corpus` from `seed`; the
algorithms run from `seed + 1`.

    PYTHONPATH=src python -m repro_torch.fig7_imdb --device cpu \\
        [--sweeps-per-launch 8] [--sampler-mode sparse] \\
        [--sparse-topic-cap 32] [--length-buckets 8]

prints each algorithm's test accuracy beside the majority class's rate.
The options are `fig6_mdna`'s.
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
SCALE = 1.0
N_DOCS = max(100, int(25000 * SCALE) // 10 * 10)
VOCAB = max(200, int(8000 * SCALE * 2))
N_TRAIN = int(N_DOCS * 0.8) // M * M
DOC_LEN = max(40, int(150 * min(1.0, SCALE * 20)))
N_TOPICS = 16
CFG = SLDAConfig(n_topics=N_TOPICS, vocab_size=VOCAB, rho=0.25, n_iters=30,
                 label_type="binary")


def make_data(seed: int, device):
    corpus, _ = make_slda_corpus(seed, N_DOCS, VOCAB, N_TOPICS, DOC_LEN,
                                 rho=0.25, label_type="binary",
                                 doc_len_dist="lognormal", device=device)
    return train_test_split(corpus, N_TRAIN)


def accuracy(yhat, y) -> float:
    return float(((yhat > 0.5) == (y > 0.5)).to(torch.float32).mean())


def run(seed: int = 1, device="cuda", data=None, cfg=CFG) -> dict:
    """All four algorithms once under `cfg` (the harness's CFG, or a
    variant of it).  Returns {"majority_rate", "padding_frac",
    "algorithms": {name: {"test_acc", "phase_ms"}}}."""
    train, test = data if data is not None else make_data(seed, device)
    pos = float((test.y > 0.5).to(torch.float32).mean())
    rows = {}
    for name, fn in ALGORITHMS.items():
        timer = PhaseTimer(device)
        args = (seed + 1, train, test, cfg) + (() if name == "nonparallel"
                                               else (M,))
        yhat = fn(*args, device=device, timer=timer)
        rows[name] = {"test_acc": accuracy(yhat, test.y),
                      "phase_ms": timer.ms()}
    return {
        "majority_rate": max(pos, 1.0 - pos),
        "padding_frac": 1.0 - float(torch.cat([train.mask, test.mask])
                                    .mean()),
        "algorithms": rows,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sweeps-per-launch", type=int, default=1)
    ap.add_argument("--sampler-mode", choices=("dense", "sparse"),
                    default="dense")
    ap.add_argument("--sparse-topic-cap", type=int,
                    default=CFG.sparse_topic_cap)
    ap.add_argument("--length-buckets", type=int,
                    default=CFG.length_buckets)
    a = ap.parse_args()
    cfg = dataclasses.replace(CFG, sweeps_per_launch=a.sweeps_per_launch,
                              sampler_mode=a.sampler_mode,
                              sparse_topic_cap=a.sparse_topic_cap,
                              length_buckets=a.length_buckets)
    print(json.dumps({"device": a.device, "seed": a.seed,
                      "sweeps_per_launch": a.sweeps_per_launch,
                      "sampler_mode": a.sampler_mode,
                      "sparse_topic_cap": a.sparse_topic_cap,
                      "length_buckets": a.length_buckets,
                      **run(a.seed, a.device, cfg=cfg)}))
