"""Combination rules — the heart of the paper.

Combining *sub-posteriors* of topics fails (quasi-ergodicity), but
combining *sub-predictions* is sound because the label is one-dimensional
and unimodal.  Section III-C:

  Simple Average    ŷ = (1/M) Σ_m ŷ^(m)                         (Eq. 7)
  Weighted Average  ŷ = Σ_m w^(m) ŷ^(m),
                    w^(m) ∝ 1/MSE_train^(m)  (continuous labels)  (Eq. 8-9)
                    w^(m) ∝ acc_train^(m)    (binary labels)
  Median            ŷ = median_m ŷ^(m)    [extension beyond the paper]

All rules accept a per-chain `alive` mask: a dead chain is dropped and
the weights renormalize over survivors.  Its predictions and weights are
zeroed with `where` BEFORE any reduction, so a NaN-poisoned chain cannot
contaminate the combine.  An all-dead mask falls back to the unmasked
combine with a RuntimeWarning.  The sums over chains run chain by chain,
left to right, the same for every column: a document's combined ŷ has
the same bits whether it is combined alone ([M, 1]) or in a batch
([M, D]), which the prediction service's re-derivation relies on, and a
chain of weight 0 adds exact zeros, so that dropping it gives the
survivors' combine bit for bit.
"""
from __future__ import annotations

import warnings

import torch

_EPS = 1e-12


def all_dead(alive) -> bool:
    """Host-side check for the degenerate mask (None counts as alive)."""
    return alive is not None and float(torch.as_tensor(alive).sum()) == 0.0


def _alive(yhat: torch.Tensor, alive):
    """The ONE copy of the alive-mask semantics: `(mask, yhat_safe)` with
    the all-ones fallback when every chain is dead, and dead rows of the
    predictions zeroed."""
    if alive is None:
        return torch.ones(yhat.shape[0], dtype=yhat.dtype,
                          device=yhat.device), yhat
    a = torch.as_tensor(alive, device=yhat.device).to(yhat.dtype)
    if float(a.sum()) == 0.0:
        warnings.warn("combine: all-dead alive mask — falling back to the "
                      "unmasked combine", RuntimeWarning, stacklevel=3)
        a = torch.ones_like(a)
    return a, torch.where(a[:, None] > 0, yhat, torch.zeros_like(yhat))


def _chain_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the leading chain dim, chain 0 first: column-independent
    (a matmul or a reduction may order a column's sum by the batch's
    width)."""
    out = x[0]
    for row in x[1:]:
        out = out + row
    return out


def simple_average(yhat: torch.Tensor, alive=None) -> torch.Tensor:
    """yhat: [M, D_test] per-chain predictions → [D_test]."""
    a, safe = _alive(yhat, alive)
    return _chain_sum(a[:, None] * safe) / _chain_sum(a).clamp(min=1.0)


def weighted_average(yhat: torch.Tensor, train_mse=None, train_acc=None,
                     alive=None) -> torch.Tensor:
    """Weights from inverse training MSE (continuous) or training accuracy
    (binary); exactly one of train_mse / train_acc must be given.  A dead
    or non-finite-weight chain contributes exactly zero."""
    a, safe = _alive(yhat, alive)
    if (train_mse is None) == (train_acc is None):
        raise ValueError("pass exactly one of train_mse / train_acc")
    raw = 1.0 / (train_mse + _EPS) if train_mse is not None else train_acc
    w = torch.where((a > 0) & torch.isfinite(raw), raw,
                    torch.zeros_like(raw))
    w = w / _chain_sum(w).clamp(min=_EPS)
    return _chain_sum(w[:, None] * safe)


def median(yhat: torch.Tensor, alive=None) -> torch.Tensor:
    """[extension] elementwise median over alive chains: dead chains are
    sorted to the top and the median indices come from the alive count,
    so dropping a chain via `alive` equals removing it."""
    a, safe = _alive(yhat, alive)
    mag = safe.abs()
    big = torch.where(torch.isnan(mag), torch.full_like(mag, -torch.inf),
                      mag).max() + 1.0
    s = torch.where(a[:, None] > 0, safe, big).sort(dim=0).values
    n = int((a > 0).sum())
    m = yhat.shape[0]
    i0 = min(max((n - 1) // 2, 0), m - 1)
    i1 = min(max(n // 2, 0), m - 1)
    return 0.5 * (s[i0] + s[i1])


COMBINERS = {
    "simple": simple_average,
    "weighted": weighted_average,
    "median": median,
}
