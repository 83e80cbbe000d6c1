"""Quickstart: train a supervised topic model and predict, the paper's way.

The port of the reference's `examples/quickstart.py`: single-machine sLDA
(the paper's Non-parallel benchmark) and the communication-free Simple
Average over 4 chains on a 320-document sLDA corpus (256 train, 60
tokens, W = 300, T = 8, 30 EM iterations), then Simple Average again
over the length-bucketed execution plan (`length_buckets=8`) through the
same entry point: its predictions are bit for bit the padded run's.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
        [--seed N]

runs on the card unless `--device cpu` is given (a few seconds on the
CPU) and prints each run's test MSE and R².  `main` returns the printed
numbers.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import SLDAConfig, run_nonparallel, run_simple_average
from repro_torch.data import make_slda_corpus, train_test_split
from repro_torch.device import resolve_device

M = 4
N_DOCS, N_TRAIN, VOCAB, N_TOPICS, DOC_LEN = 320, 256, 300, 8, 60
CFG = SLDAConfig(n_topics=N_TOPICS, vocab_size=VOCAB, n_iters=30, rho=0.25)


def _mse(yhat, y) -> float:
    return float(((yhat - y) ** 2).mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpus's seed; the runs take seed + 1")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus, _ = make_slda_corpus(args.seed, N_DOCS, VOCAB, N_TOPICS, DOC_LEN,
                                 rho=0.25, device=dev)
    train, test = train_test_split(corpus, N_TRAIN)
    var_y = float(test.y.var(unbiased=False))
    out = {"var_y_test": var_y}

    # single-machine sLDA (the paper's Non-parallel benchmark)
    yhat = run_nonparallel(args.seed + 1, train, test, CFG, device=dev)
    out["nonparallel_mse"] = mse = _mse(yhat, test.y)
    print(f"non-parallel  : test MSE {mse:.4f}  (R² {1 - mse / var_y:.3f})")

    # the paper's communication-free parallel algorithm, M=4 chains
    padded = run_simple_average(args.seed + 1, train, test, CFG, M,
                                device=dev)
    out["simple_mse"] = mse = _mse(padded, test.y)
    print(f"simple average: test MSE {mse:.4f}  (R² {1 - mse / var_y:.3f})  "
          f"— {M} chains, zero training communication")

    # ragged corpora need no separate API: the same entry point, with
    # cfg.length_buckets > 0, runs over the length-bucketed execution plan
    # (`python -m repro_torch.launch.dryrun --slda-plan` shows the plan)
    cfg_ragged = dataclasses.replace(CFG, length_buckets=8)
    yhat = run_simple_average(args.seed + 1, train, test, cfg_ragged, M,
                              device=dev)
    out["simple_ragged_mse"] = mse = _mse(yhat, test.y)
    out["ragged_equals_padded"] = bool(torch.equal(yhat, padded))
    print(f"simple average: test MSE {mse:.4f}  (R² {1 - mse / var_y:.3f})  "
          f"— same algorithm over the ragged execution plan")
    print(f"  predictions bit for bit the padded run's: "
          f"{out['ragged_equals_padded']}")
    return out


if __name__ == "__main__":
    main()
