"""Shared building blocks of the LM zoo.  Every activation and weight
carries the reference's leading chain dim `c` (the paper's
communication-free ensemble axis); nothing here reduces across it."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops
from .layout import PLAIN, placements


class Init:
    """Where a model's tensors come from: drawn on `generator` (weights
    Normal(0, 1/fan_in), as the reference's `dense_init`; norms ones,
    biases zeros) and moved to `device`, or, with no generator, left
    empty for a loader to fill (`convert.lm_params_from_numpy`).
    `trainable` makes the model's weights require gradients; a serving
    model's do not."""

    def __init__(self, device, generator=None, *, trainable=False):
        self.device = torch.device(device)
        self.generator = generator
        self.trainable = trainable

    def dense(self, fan_in, shape, dtype):
        if self.generator is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        w = torch.randn(shape, generator=self.generator, dtype=dtype,
                        device=self.generator.device)
        return w.mul_(fan_in ** -0.5).to(self.device)

    def full(self, value, shape, dtype):
        return torch.full(shape, value, dtype=dtype, device=self.device)


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, created without a gradient; a model built from a
    trainable `Init` turns gradients on for all of its weights."""
    return nn.Parameter(t, requires_grad=False)


def rmsnorm(x, w, eps, use_kernels=True):
    """x [c, ..., D]; w [c, D] scales chain c's rows (kernel B7 on the
    card unless `use_kernels` is false)."""
    return ops.rmsnorm(x, w, eps=eps, use_kernels=use_kernels)


def rope(x, positions, theta):
    """Rotary embedding in float32, cast back.  x [c, b, s, h, hd];
    positions [c, b, s]; the halves of hd rotate as pairs."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=x.device) / (hd // 2))
    ang = positions[..., None].to(torch.float32) * freqs     # [c,b,s,hd/2]
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


class MLP(nn.Module):
    """SwiGLU.  x [c, b, s, D] → [c, b, s, D]."""

    def __init__(self, d_model, d_ff, n_chains, dtype, init: Init):
        super().__init__()
        C, D = n_chains, d_model
        self.w_gate = param(init.dense(D, (C, D, d_ff), dtype))
        self.w_up = param(init.dense(D, (C, D, d_ff), dtype))
        self.w_down = param(init.dense(d_ff, (C, d_ff, D), dtype))

    def forward(self, x, compute_dtype, layout=PLAIN):
        cd, L = compute_dtype, layout
        g = L.proj("cbsd,cdf->cbsf", x, self.w_gate, cd)
        u = L.proj("cbsd,cdf->cbsf", x, self.w_up, cd)
        return L.proj("cbsf,cfd->cbsd", F.silu(g) * u, self.w_down, cd)


def _lookup(table, tokens):
    ci = torch.arange(tokens.shape[0], device=tokens.device)[:, None, None]
    return table[ci, tokens.long()]


def embed(table, tokens, compute_dtype, layout=PLAIN):
    """table [c, V, D]; tokens [c, b, s] → [c, b, s, D], chain c's rows
    gathered from its own table.  Sharded, the lookup runs on each chain's
    whole table (cast first, then gathered over `model` and the FSDP
    axis, unless `opt_replicate_embed` left it whole)."""
    L = layout
    if not L.sharded:
        return _lookup(table, tokens).to(compute_dtype)
    return L.region(_lookup, (table.to(compute_dtype), tokens),
                    (L.chain_only(3), L.act(3)), L.act(4))


def unembed(table, x, compute_dtype, layout=PLAIN):
    """Tied output projection: x [c, b, s, D] against table [c, V, D]."""
    return layout.proj("cbsd,cvd->cbsv", x, table, compute_dtype)


def _token_ce(logits, targets, z_weight):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    ce = lse - gold
    if z_weight:
        ce = ce + z_weight * lse.square()
    return ce


def cross_entropy(logits, targets, z_weight: float = 0.0, layout=PLAIN):
    """Per-chain mean cross-entropy in float32: logits [c, b, s, V],
    targets [c, b, s] → loss [c], with the optional z-loss z_weight ·
    logsumexp² (the reference's `cross_entropy`).  Sharded, a vocabulary
    that splits over `model` is reduced there shard by shard
    (`_vocab_parallel_ce`), else each token's loss takes its whole row,
    and the mean over the batch reduces over the data-parallel axes."""
    L = layout
    if L.msize > 1 and L.fits(logits.shape[-1]):
        ce = _vocab_parallel_ce(logits, targets, z_weight, L)
    else:
        ce = L.region(lambda lg, t: _token_ce(lg, t, z_weight),
                      (logits, targets), (L.act(4), L.act(3)), L.act(3))
    return ce.mean(dim=(1, 2))


def _vocab_parallel_ce(logits, targets, z_weight, L):
    """Each token's loss with the vocabulary split over `model`: the max
    (all-reduced), and each shard's sum of exponentials and target logit
    (picked by comparing the targets with the shard's own vocabulary
    ids), summed over `model`.  No device holds a whole row of logits,
    in the forward pass or the backward."""
    from torch.distributed.tensor import distribute_tensor
    lf = L.put(logits, L.act(4, 3))
    mx = L.put(lf.detach().float().amax(-1, keepdim=True), L.act(4))
    vid = distribute_tensor(torch.arange(logits.shape[-1],
                                         device=logits.device),
                            L.mesh, placements(("model",), L.mesh),
                            src_data_rank=None)

    def shard_terms(lf, mx, targets, vid):
        lf = lf.float()
        sumexp = (lf - mx).exp().sum(-1)
        gold = (lf * (vid == targets.long()[..., None])).sum(-1)
        return sumexp, gold
    sumexp, gold = L.region(shard_terms, (lf, mx, targets, vid),
                            (L.act(4, 3), L.act(4), L.act(3), ("model",)),
                            [L.act(3), L.act(3)], partial=("model",))
    lse = L.put(sumexp, L.act(3)).log() + mx[..., 0]
    ce = lse - L.put(gold, L.act(3))
    if z_weight:
        ce = ce + z_weight * lse.square()
    return ce
