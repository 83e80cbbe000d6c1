"""Test-time prediction for sLDA, Eqs. (4)–(5).

Given a trained model (φ̂, η̂), sample topic assignments for the test
documents under

    p(z=t | ·) ∝ (N_dt^{-dn}+α)/(N_d^{-dn}+Tα) · φ̂_{t,w}

(unsupervised — the label is what we predict), then report
ŷ_d = η̂ᵀ z̄_d with z̄ averaged over the last `n_pred_samples` sweeps after
`n_pred_burnin` burn-in sweeps.  One model is M = 1 of the chain-batched
prediction pass: one launch of kernel B1 on the card.
"""
from __future__ import annotations

import torch

from .types import Corpus, SLDAConfig, SLDAModel


def predict(seed: int, model: SLDAModel, corpus: Corpus, cfg: SLDAConfig,
            *, device="cuda") -> torch.Tensor:
    """ŷ [D] for every document in `corpus` under `model`."""
    from .parallel import predict_chains
    return predict_chains(seed, model.map(lambda a: a[None]), corpus, cfg,
                          device=device)[0]
