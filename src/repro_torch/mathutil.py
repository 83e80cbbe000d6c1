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


def per_chain(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn over each chain's slice [c:c+1] of the chain-batched operands
    xs (leading dim M), concatenated along it: every chain's result is
    computed at the shapes of a batch of one, so its bits do not depend
    on how many chains share the call.  A batched product, solve or
    reduction may order its sums by the batch's size (ROADMAP C7): on the
    CPU [M, T, D] @ [M, D, 1] differed in the last bits between M = 1 and
    M = 4 at D = 750, T = 16; on an H100 the Gram product Z̄ᵀZ̄, the solve
    and the train MSE's mean over documents did too.  A process running a
    block of an ensemble's chains must not see that."""
    m = xs[0].shape[0]
    if m == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[c:c + 1] for x in xs)) for c in range(m)])


#: chains a call of `per_chain_group`
CHAIN_GROUP = 4


def per_chain_group(fn, *xs: torch.Tensor) -> torch.Tensor:
    """fn over groups of exactly CHAIN_GROUP chains of the chain-batched
    operands xs, the last group filled up with copies of its last chain
    (their results dropped), concatenated: every call has the same batch
    shape whatever M is, so a batched library call takes the same path
    for each group, and each chain's result is computed as by a batch of
    one group (ROADMAP C7).  One call at the paper's M = 4, where
    `per_chain` makes four: on an H100 the η solve's cuSOLVER path
    changes between batches of 2 and 3 at T = 16, and between 8 and 16
    at T = 512, and a solve costs about 0.1–0.3 ms of host time."""
    outs = []
    for lo in range(0, xs[0].shape[0], CHAIN_GROUP):
        part = [x[lo:lo + CHAIN_GROUP] for x in xs]
        take = part[0].shape[0]
        if take < CHAIN_GROUP:
            part = [torch.cat([p, p[-1:].expand(
                (CHAIN_GROUP - take,) + tuple(p.shape[1:]))]) for p in part]
        outs.append(fn(*part)[:take])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def chain_matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [..., R, K] times v [..., K] → [..., R]; for chain-batched
    operands ([M, R, K], [M, K]) chain by chain (`per_chain`)."""
    def mv(x, w):
        return (x @ w[..., None])[..., 0]
    return per_chain(mv, a, v) if a.dim() > 2 else mv(a, v)
