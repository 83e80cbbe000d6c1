"""Top-k token-choice MoE with capacity-buffer dispatch, the reference's
`moe` (scatter-based, not the quadratic dispatch einsum).

Route: softmax → top-k → renormalise.  The T·K (token, choice) slots are
sorted by expert id (a stable sort, as `jnp.argsort`), each slot gets its
position within its expert's group, and slots beyond an expert's
capacity

  C_e = max(8, int(ceil(T · top_k / E) · capacity_factor))

are dropped: their token's residual passes through.  The dispatch buffer
is [c, E, C_e, D], the experts' SwiGLU runs batched over E on it, and the
combine gathers each kept slot back, weighted by its gate.  Arctic's
`moe_dense_d_ff` adds a dense residual MLP in parallel.  The Switch aux
load-balance loss on the top-1 choice is returned for the train loss.

Plain torch on every device: the reference computes MoE in jnp, with no
Pallas kernel.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .layers import MLP, Init, param


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """C_e, an expert's slots for `n_tokens` tokens (the reference's
    `_capacity`)."""
    per = math.ceil(n_tokens * cfg.moe_top_k / cfg.n_experts)
    return max(8, int(per * cfg.capacity_factor))


def route(xt, router, k):
    """Router probabilities and the top-k choices of tokens xt [c, T, D]
    under router [c, D, E], in float32: (probs [c, T, E], gate [c, T, K]
    renormalised, eidx [c, T, K]).  The top k come from a stable
    descending sort, so ties go to the lower expert id, as
    `jax.lax.top_k` breaks them (`torch.topk` promises no order)."""
    logits = torch.einsum("ctd,cde->cte", xt.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[..., :k], eidx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, eidx


def slots(eidx, cap):
    """The slot bookkeeping of choices eidx [c, T, K] at capacity `cap`:
    (order [c, TK], the stable sort of the slots by expert; sorted_e
    [c, TK], their experts; pos [c, TK], each sorted slot's position in
    its expert's group; keep [c, TK], pos < cap)."""
    c, T, K = eidx.shape
    slot_e = eidx.reshape(c, T * K)
    order = torch.argsort(slot_e, dim=-1, stable=True)
    sorted_e = torch.gather(slot_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(T * K, device=eidx.device)[None, :] - first
    return order, sorted_e, pos, pos < cap


def switch_aux(probs, eidx):
    """The Switch load-balance loss [c]: E · Σ_e (share of tokens whose
    top-1 choice is e) · (mean probability of e)."""
    E = probs.shape[-1]
    frac = F.one_hot(eidx[..., 0], E).float().mean(1)
    return E * (frac * probs.mean(1)).sum(-1)


class MoE(nn.Module):
    """The router float32 [c, D, E] in every model; the experts' w_gate /
    w_up [c, E, D, F] and w_down [c, E, F, D]; `dense`, Arctic's residual
    MLP, when `moe_dense_d_ff > 0`."""

    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.cfg = cfg
        C, D, E, F_ = n_chains, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = param(init.dense(D, (C, D, E), torch.float32))
        self.w_gate = param(init.dense(D, (C, E, D, F_), dtype))
        self.w_up = param(init.dense(D, (C, E, D, F_), dtype))
        self.w_down = param(init.dense(F_, (C, E, F_, D), dtype))
        self.dense = (MLP(D, cfg.moe_dense_d_ff, C, dtype, init)
                      if cfg.moe_dense_d_ff else None)
        self.drops = None        # a list while `moe_drops` reports

    def forward(self, x, compute_dtype):
        """x [c, b, s, D] → (y [c, b, s, D], aux [c]).

        Every slot is written to (its expert, min(pos, C_e - 1)) by an
        add, a dropped slot adding zeros, as the reference's `.at[].add`:
        an assignment would let a dropped slot overwrite the kept token at
        C_e - 1.  The combine adds a token's K choices into zeros; with
        K = 2 (every config) that sum is exact in either order."""
        cfg, cd = self.cfg, compute_dtype
        c, b, s, D = x.shape
        E, K, T = cfg.n_experts, cfg.moe_top_k, b * s
        cap = capacity(T, cfg)
        xt = x.reshape(c, T, D)
        probs, gate, eidx = route(xt, self.router, K)
        aux = switch_aux(probs, eidx)
        order, sorted_e, pos, keep = slots(eidx, cap)
        if self.drops is not None:
            self.drops.append(1.0 - keep.float().mean())
        tok = order // K                                   # each slot's token
        ci = torch.arange(c, device=x.device)[:, None]
        at = pos.clamp(max=cap - 1)

        upd = torch.where(keep[..., None], xt[ci, tok].to(cd),
                          torch.zeros((), dtype=cd, device=x.device))
        buf = torch.zeros((c, E, cap, D), dtype=cd, device=x.device)
        buf = buf.index_put((ci, sorted_e, at), upd, accumulate=True)

        g = torch.einsum("cekd,cedf->cekf", buf, self.w_gate.to(cd))
        u = torch.einsum("cekd,cedf->cekf", buf, self.w_up.to(cd))
        out_buf = torch.einsum("cekf,cefd->cekd", F.silu(g) * u,
                               self.w_down.to(cd))

        sorted_gate = torch.gather(gate.reshape(c, T * K), 1, order)
        vals = out_buf[ci, sorted_e, at]                   # [c, TK, D]
        vals = torch.where(keep[..., None], vals,
                           torch.zeros((), dtype=cd, device=x.device)) \
            * sorted_gate[..., None]
        y = torch.zeros((c, T, D), dtype=cd, device=x.device).index_put(
            (ci, tok), vals.to(cd), accumulate=True).reshape(c, b, s, D)
        if self.dense is not None:                         # Arctic residual
            y = y + self.dense(x, cd)
        return y, aux


@contextlib.contextmanager
def moe_drops(model):
    """Inside the block every MoE layer's forward pass records the share
    of its (token, choice) slots dropped at capacity into the yielded
    list, one entry a layer and call; the entries are floats once the
    block ends (a report; nothing is changed)."""
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    shares = []
    for m in layers:
        m.drops = shares
    try:
        yield shares
    finally:
        for m in layers:
            m.drops = None
        shares[:] = [float(x) for x in shares]
