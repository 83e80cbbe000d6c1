"""The four algorithms of Section IV, sharing one chain-batched sampler.

  non-parallel      one chain on the full training corpus (paper benchmark 1)
  naive             M chains; pool the *sampled topics* as if drawn on the
                    full corpus, fit (η, φ) globally, predict once
                    (paper benchmark 2 — exhibits quasi-ergodicity)
  simple-average    M chains; each predicts the test set; Eq. (7) combine
  weighted-average  M chains; each predicts test AND full train set (for the
                    weights); Eq. (8)-(9) combine

Each algorithm trains all its chains in one chain-batched EM loop (on
the card, one kernel-B2 launch per sweep, or one kernel-B3 launch per
`cfg.sweeps_per_launch` sweeps) and predicts in one chain-batched pass
(one kernel-B1 launch).  `seed` names the run: every chain draws
from its own generator seeded from (seed, stream, chain) (`core.rng`).
`timer`, when given, is entered as `timer(phase)` around the "train",
"predict" and "combine" phases.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device
from . import combine, rng
from .plan import build_plan
from .regression import solve_eta_ols
from .types import Corpus, SLDAConfig, SLDAModel, _concat_corpora, partition


def _no_timer(phase):
    return contextlib.nullcontext()


# ----------------------------------------------- chain-batched training

def train_chains_keyed(z_init, draws, shards: Corpus, cfg: SLDAConfig):
    """Train M independent chains (no communication) from explicit draws:
    z_init [M, D/M, N] and an iterable of the EM loop's draws — n_iters
    uniforms [M, D/M, N] at sweeps_per_launch=1, else one seed tensor
    [M, D/M] per fused launch (`rng.train_draws`).  shards is
    [M, D/M, ...] on the draws' device.  Returns (GibbsState, SLDAModel),
    each with leading chain dim."""
    return build_plan(shards, cfg).train(z_init, draws)


def train_chains(seed: int, shards: Corpus, cfg: SLDAConfig, *,
                 device="cuda"):
    """Train M independent chains (no communication). shards is
    [M, D/M, ...].  Returns (GibbsState, SLDAModel) on `device`."""
    dev = resolve_device(device)
    shards = shards.to(dev)
    m, d, n = shards.tokens.shape
    z_init, draws = rng.train_draws(
        rng.chain_generators(seed, m, dev, rng.TRAIN), d, n, cfg.n_topics,
        cfg.n_iters, cfg.sweeps_per_launch)
    return train_chains_keyed(z_init, draws, shards, cfg)


# --------------------------------------------- chain-batched prediction

def predict_chains_keyed(z0, seeds, models: SLDAModel, corpus: Corpus,
                         cfg: SLDAConfig) -> torch.Tensor:
    """Every chain predicts every document of the SHARED `corpus` → [M, D],
    from explicit draws z0 [M, D, N] and per-document seeds [M, D]."""
    return build_plan(corpus, cfg).predict(z0, seeds, models)


def predict_chains(seed: int, models: SLDAModel, corpus: Corpus,
                   cfg: SLDAConfig, *, device="cuda",
                   stream: int = rng.PREDICT) -> torch.Tensor:
    """Every chain predicts every document of `corpus` → [M, D]."""
    dev = resolve_device(device)
    corpus, models = corpus.to(dev), models.to(dev)
    z0, seeds = rng.predict_draws(
        rng.chain_generators(seed, models.eta.shape[0], dev, stream),
        corpus.n_docs, corpus.max_len, cfg.n_topics)
    return predict_chains_keyed(z0, seeds, models, corpus, cfg)


# ---------------------------------------------------------------- algorithms

def run_nonparallel(seed: int, train: Corpus, test: Corpus,
                    cfg: SLDAConfig, *, device="cuda", timer=_no_timer):
    with timer("train"):
        _, models = train_chains(seed, partition(train, 1), cfg,
                                 device=device)
    with timer("predict"):
        return predict_chains(seed, models, test, cfg, device=device)[0]


def run_naive(seed: int, train: Corpus, test: Corpus, cfg: SLDAConfig,
              m: int, *, device="cuda", timer=_no_timer):
    """Naive Combination: pool sub-sampled topics, then fit + predict once."""
    dev = resolve_device(device)
    shards = partition(train, m).to(dev)
    with timer("train"):
        states, _ = train_chains(seed, shards, cfg, device=dev)
    with timer("combine"):
        # step 3: treat the union of sub-samples as one global sample
        lengths = shards.lengths().clamp(min=1.0)             # [M, D/M]
        zbar_all = (states.ndt / lengths[..., None]).reshape(-1,
                                                             cfg.n_topics)
        eta = solve_eta_ols(zbar_all, shards.y.reshape(-1))   # 3(a): OLS
        ntw = states.ntw.sum(0)                               # 3(b): pooled φ
        phi = (ntw + cfg.beta) / (ntw.sum(-1, keepdim=True)
                                  + cfg.vocab_size * cfg.beta)
        zero = torch.zeros((), device=dev)
        model = SLDAModel(phi=phi[None], eta=eta[None],
                          train_mse=zero[None], train_acc=zero[None])
    with timer("predict"):
        return predict_chains(seed, model, test, cfg, device=dev)[0]


def run_simple_average(seed: int, train: Corpus, test: Corpus,
                       cfg: SLDAConfig, m: int, alive=None, *,
                       device="cuda", timer=_no_timer):
    with timer("train"):
        _, models = train_chains(seed, partition(train, m), cfg,
                                 device=device)
    with timer("predict"):
        yhat = predict_chains(seed, models, test, cfg, device=device)
    with timer("combine"):
        return combine.simple_average(yhat, alive=alive)


def _combine_weighted(yhat_te, yhat_tr, train_y, cfg: SLDAConfig, alive):
    """Eq. (8)-(9): weight each chain's test predictions by its
    full-training-set accuracy (binary) or MSE (continuous)."""
    if cfg.label_type == "binary":
        acc = ((yhat_tr > 0.5) == (train_y[None, :] > 0.5)).to(
            torch.float32).mean(-1)
        return combine.weighted_average(yhat_te, train_acc=acc, alive=alive)
    mse = ((yhat_tr - train_y[None, :]) ** 2).mean(-1)
    return combine.weighted_average(yhat_te, train_mse=mse, alive=alive)


def run_weighted_average(seed: int, train: Corpus, test: Corpus,
                         cfg: SLDAConfig, m: int, alive=None, *,
                         device="cuda", timer=_no_timer):
    """The weights use the *full training set* MSE/accuracy of each local
    model (Section III-C(d)).  With `cfg.fuse_weighted_predict` (the
    default) the test and train passes run as ONE chain-batched
    prediction pass over the concatenated corpus."""
    dev = resolve_device(device)
    train, test = train.to(dev), test.to(dev)
    with timer("train"):
        _, models = train_chains(seed, partition(train, m), cfg, device=dev)
    with timer("predict"):
        if cfg.fuse_weighted_predict:
            yhat = predict_chains(seed, models, _concat_corpora(test, train),
                                  cfg, device=dev)
            yhat_te, yhat_tr = yhat[:, :test.n_docs], yhat[:, test.n_docs:]
        else:
            yhat_te = predict_chains(seed, models, test, cfg, device=dev)
            yhat_tr = predict_chains(seed, models, train, cfg, device=dev,
                                     stream=rng.PREDICT_TRAIN)
    with timer("combine"):
        return _combine_weighted(yhat_te, yhat_tr, train.y, cfg, alive)


ALGORITHMS = {
    "nonparallel": run_nonparallel,
    "naive": run_naive,
    "simple": run_simple_average,
    "weighted": run_weighted_average,
}
