"""The paper's full Section-IV comparison and the fault-tolerance dividend.

The port of the reference's `examples/parallel_slda.py`:

1. Runs all four algorithms (Non-parallel, Naive Combination, Simple
   Average, Weighted Average) on a 400-document sLDA corpus (320 train,
   60 tokens, W = 300, T = 8, 30 EM iterations, M = 4) and prints the
   time / accuracy comparison of Figures 6-7; then Weighted Average over
   the length-bucketed execution plan (`length_buckets=6`) through the
   same entry point, beside the plan it runs (`describe()`: the
   staircase executor on the CPU, the blocks executor on the card).
2. Shows what communication-free chains buy: drop chains after training
   and the combiner renormalizes over the survivors, with no retraining
   and no resharding.

    PYTHONPATH=src python -m repro_torch.parallel_slda [--device cpu]
        [--seed N]

runs on the card unless `--device cpu` is given (some 15 s on the CPU).
`main` returns the printed numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.core import (ALGORITHMS, SLDAConfig, build_plan,
                              build_schedule, combine, partition,
                              predict_chains, train_chains)
from repro_torch.data import make_slda_corpus, train_test_split
from repro_torch.device import resolve_device

M = 4
N_DOCS, N_TRAIN, VOCAB, N_TOPICS, DOC_LEN = 400, 320, 300, 8, 60
CFG = SLDAConfig(n_topics=N_TOPICS, vocab_size=VOCAB, n_iters=30, rho=0.25)
ALIVE = ((1, 1, 1, 1), (1, 0, 1, 1), (1, 0, 0, 1))


def _mse(yhat, y) -> float:
    return float(((yhat - y) ** 2).mean())


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the corpus's seed; the runs take seed + 1 to + 3")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus, _ = make_slda_corpus(args.seed, N_DOCS, VOCAB, N_TOPICS, DOC_LEN,
                                 rho=0.25, device=dev)
    train, test = train_test_split(corpus, N_TRAIN)
    var_y = float(test.y.var(unbiased=False))
    out = {"var_y_test": var_y, "algorithms": {}}

    print("=== the paper's four algorithms (Fig. 6 layout) ===")
    yhats = {}
    for name, fn in ALGORITHMS.items():
        call = (lambda fn=fn, m=() if name == "nonparallel" else (M,): fn(
            args.seed + 1, train, test, CFG, *m, device=dev))
        if dev.type == "cuda":
            call()                # a warm-up: the first call's lazy set-up
        _sync(dev)
        t0 = time.perf_counter()
        yhats[name] = call()
        _sync(dev)
        wall = time.perf_counter() - t0
        mse = _mse(yhats[name], test.y)
        out["algorithms"][name] = {"wall_s": wall, "mse": mse,
                                   "r2": 1 - mse / var_y}
        print(f"  {name:12s} wall {wall:6.2f}s   "
              f"test MSE {mse:.4f}   R² {1 - mse / var_y:.3f}")

    print("\n=== same algorithms over the ragged execution plan ===")
    # a length-bucketed config routes the same entry points through the
    # ragged execution layer: no bucketed twins of the algorithms
    cfg_ragged = dataclasses.replace(CFG, length_buckets=6)
    d = build_plan(build_schedule(train, cfg_ragged), cfg_ragged).describe()
    print(f"  plan: executor={d['executor']} buckets={d['bucket_widths']} "
          f"slot/real tokens {d['slot_tokens_per_sweep']}/"
          f"{d['real_tokens_per_sweep']}")
    yhat = ALGORITHMS["weighted"](args.seed + 1, train, test, cfg_ragged, M,
                                  device=dev)
    mse = _mse(yhat, test.y)
    out["ragged"] = {"executor": d["executor"],
                     "bucket_widths": d["bucket_widths"],
                     "slot_tokens_per_sweep": d["slot_tokens_per_sweep"],
                     "real_tokens_per_sweep": d["real_tokens_per_sweep"],
                     "weighted_mse": mse, "r2": 1 - mse / var_y,
                     "equals_padded": bool(torch.equal(
                         yhat, yhats["weighted"]))}
    print(f"  weighted (ragged plan)   test MSE {mse:.4f}   "
          f"R² {1 - mse / var_y:.3f}   (ŷ bit for bit the padded run's: "
          f"{out['ragged']['equals_padded']})")

    print("\n=== fault tolerance: drop a chain, renormalize, carry on ===")
    _, models = train_chains(args.seed + 2, partition(train, M), CFG,
                             device=dev)
    yhat_all = predict_chains(args.seed + 3, models, test, CFG,
                              device=dev)                    # [M, D_test]
    out["kill"] = []
    for alive in ALIVE:
        yhat = combine.weighted_average(
            yhat_all, train_mse=models.train_mse,
            alive=torch.tensor(alive, dtype=torch.float32, device=dev))
        mse = _mse(yhat, test.y)
        out["kill"].append({"alive": list(alive), "mse": mse})
        print(f"  chains alive {list(alive)}  test MSE {mse:.4f}")
    # the same predictions under Weighted Average's combine with no mask
    out["kill_unmasked_mse"] = mse = _mse(combine.weighted_average(
        yhat_all, train_mse=models.train_mse), test.y)
    print(f"  no alive mask             test MSE {mse:.4f}")
    return out


if __name__ == "__main__":
    main()
