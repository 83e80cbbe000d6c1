"""Leaf numeric helpers shared by core and kernels."""
from __future__ import annotations

import torch


def upper_tri_ones(n: int, device=None) -> torch.Tensor:
    """U[j, k] = 1 ⇔ j ≤ k: the reference's prefix-sum-as-matmul
    contraction matrix (`p @ U` is the inclusive prefix sum of p along its
    last axis, in whatever order the GEMM adds)."""
    i = torch.arange(n, device=device)
    return (i[:, None] <= i[None, :]).to(torch.float32)


def prefix_sum(p: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of p [..., T] along its last axis, left to
    right: entry t is the float32 chain (..((p_0 + p_1) + p_2)..) + p_t
    that the kernels compute, at every T and on every device, by T - 1
    adds of [...] vectors.  Every plain draw of the port sums through it.
    Neither the reference's GEMM `p @ triu(T)` nor `torch.cumsum` would
    do: on the card one GEMM adds some rows out of this order (at T = 16,
    40 and 256 among others), and the CUDA cumsum scans in tree order.
    On the CPU the GEMM does add in this order at the tests' shapes, so
    the sums stay bit-equal to the reference's (`tests/test_torch_kernels
    .py`)."""
    cols = list(p.unbind(-1))
    for t in range(1, len(cols)):
        cols[t] = cols[t - 1] + cols[t]
    return torch.stack(cols, -1)
