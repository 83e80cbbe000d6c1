"""Leaf numeric helpers shared by core and kernels."""
from __future__ import annotations

import torch


def upper_tri_ones(n: int, device=None) -> torch.Tensor:
    """U[j, k] = 1 ⇔ j ≤ k: the prefix-sum-as-matmul contraction matrix.

    `p @ U` is the inclusive prefix sum of p along its last axis; every
    plain sampler of the port draws through it, as the reference does."""
    i = torch.arange(n, device=device)
    return (i[:, None] <= i[None, :]).to(torch.float32)


# The kernels sum each row left to right; one float32 GEMM p @ U on the
# card does not always.  chip_smoke.py's prefix_order phase (an H100,
# cuBLAS of CUDA 12.8) finds its rows out of that order at T = 16 for 750
# to 4,216 rows (in order at 16,864) and at T = 40, 256 and 512, and in
# order only at T = 3 and 128.  A draw whose u·total falls between two
# such sums differs; up to 256 topics the draws that do stay inside the
# samplers' gates (1e-3), and past 256 they did not (B3 at T = 512: 0.00108
# of the first sweep's draws), so there the sum is taken in 128-column
# pieces, each carrying the prefix before it in, which the phase finds in
# order at T = 512.  An ordered sum at every T is left to its own change.
_ONE_GEMM_TOPICS = 256
_PIECE = 128


def prefix_sum(p: torch.Tensor, tri_u: torch.Tensor | None = None):
    """The inclusive prefix sum of p [..., T] along its last axis: `p @ U`
    (tri_u, `upper_tri_ones(T)`), and past 256 topics GEMMs over
    128-column pieces, each carrying the prefix before it in as its first
    term, so that no GEMM sums more than 129 terms.  On the CPU at the
    tests' shapes each entry is the left-to-right chain
    (..((p_0 + p_1) + p_2)..) + p_t the kernels compute
    (`tests/test_torch_kernels.py`); on the card, see the note above."""
    T = p.shape[-1]
    if tri_u is None:
        tri_u = upper_tri_ones(T, p.device)
    if T <= _ONE_GEMM_TOPICS:
        return p @ tri_u
    w = torch.cat([torch.ones_like(tri_u[:1, :_PIECE]),
                   tri_u[:_PIECE, :_PIECE]])
    out, prev = [], p.new_zeros(p.shape[:-1] + (1,))
    for a in range(0, T, _PIECE):
        piece = p[..., a:a + _PIECE]
        n = piece.shape[-1]
        c = torch.cat([prev, piece], -1) @ w[:n + 1, :n]
        out.append(c)
        prev = c[..., -1:]
    return torch.cat(out, -1)
