"""The M-step of sLDA's stochastic EM: the regression parameters η.

Maximizing Eq. (2),

    L(η) = -1/(2ρ) Σ_d (y_d - ηᵀ z̄_d)² - 1/(2σ) Σ_t (η_t - μ)²,

is ridge regression with prior mean μ; the closed form is

    (Z̄ᵀZ̄/ρ + I/σ) η = Z̄ᵀ y / ρ + μ/σ.

T is small (tens), so a dense float32 solve is exact enough and cheap.
Leading dims of `zbar` [..., D, T] and `y` [..., D] are independent
chains, solved in one batched call.
"""
from __future__ import annotations

import torch

from .types import SLDAConfig


def _eye(zbar):
    T = zbar.shape[-1]
    return torch.eye(T, dtype=zbar.dtype, device=zbar.device)


def solve_eta(zbar: torch.Tensor, y: torch.Tensor,
              cfg: SLDAConfig) -> torch.Tensor:
    zt = zbar.transpose(-1, -2)
    gram = zt @ zbar / cfg.rho + _eye(zbar) / cfg.sigma
    rhs = (zt @ y[..., None])[..., 0] / cfg.rho + cfg.mu / cfg.sigma
    return torch.linalg.solve(gram, rhs)


def solve_eta_ols(zbar: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain OLS (tiny jitter for rank safety) — the paper's Naive
    Combination step 3(a) fits η by *ordinary* linear regression on the
    pooled sub-samples."""
    zt = zbar.transpose(-1, -2)
    gram = zt @ zbar + 1e-6 * _eye(zbar)
    return torch.linalg.solve(gram, (zt @ y[..., None])[..., 0])
