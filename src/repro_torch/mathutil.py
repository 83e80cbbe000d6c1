"""Leaf numeric helpers shared by core and kernels."""
from __future__ import annotations

import torch


def upper_tri_ones(n: int, device=None) -> torch.Tensor:
    """U[j, k] = 1 ⇔ j ≤ k: the prefix-sum-as-matmul contraction matrix.

    `p @ U` is the inclusive prefix sum of p along its last axis; every
    plain sampler of the port draws through it, as the reference does."""
    i = torch.arange(n, device=device)
    return (i[:, None] <= i[None, :]).to(torch.float32)
