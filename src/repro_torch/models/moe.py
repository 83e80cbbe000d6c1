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
from .layout import PLAIN, spec_entry


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

    def forward(self, x, compute_dtype, layout=PLAIN):
        """x [c, b, s, D] → (y [c, b, s, D], aux [c]).

        Every slot is written to (its expert, min(pos, C_e - 1)) by an
        add, a dropped slot adding zeros, as the reference's `.at[].add`:
        an assignment would let a dropped slot overwrite the kept token at
        C_e - 1.  The combine adds a token's K choices into zeros; with
        K = 2 (every config) that sum is exact in either order.

        Sharded, the routing and the combine see all of a chain's tokens
        (x is gathered over the data-parallel axes: the capacity is the
        chain's, as in the reference), the experts run on the dispatch
        buffer's slots split over the data-parallel axes, and its experts
        split over `model` under `moe_ep` (the weights stay where they
        are) or whole (the weights gathered over `model`)."""
        cfg, cd, L = self.cfg, compute_dtype, layout
        c, b, s, D = x.shape
        E, K, T = cfg.n_experts, cfg.moe_top_k, b * s
        cap = capacity(T, cfg)
        zero = torch.zeros((), dtype=cd, device=x.device)

        def dispatch(x, router):
            c = x.shape[0]
            xt = x.reshape(c, T, D)
            probs, gate, eidx = route(xt, router, K)
            aux = switch_aux(probs, eidx)
            order, sorted_e, pos, keep = slots(eidx, cap)
            if self.drops is not None:
                self.drops.append(1.0 - keep.float().mean())
            tok = order // K                               # each slot's token
            ci = torch.arange(c, device=x.device)[:, None]
            at = pos.clamp(max=cap - 1)
            upd = torch.where(keep[..., None], xt[ci, tok].to(cd), zero)
            buf = torch.zeros((c, E, cap, D), dtype=cd, device=x.device)
            buf = buf.index_put((ci, sorted_e, at), upd, accumulate=True)
            sorted_gate = torch.gather(gate.reshape(c, T * K), 1, order)
            return buf, aux, sorted_e, at, keep, tok, sorted_gate

        def experts(buf, wg, wu, wd):
            g = torch.einsum("cekd,cedf->cekf", buf, wg)
            u = torch.einsum("cekd,cedf->cekf", buf, wu)
            return torch.einsum("cekf,cefd->cekd", F.silu(g) * u, wd)

        def combine(out_buf, sorted_e, at, keep, tok, sorted_gate):
            c = out_buf.shape[0]
            ci = torch.arange(c, device=out_buf.device)[:, None]
            vals = out_buf[ci, sorted_e, at]               # [c, TK, D]
            vals = torch.where(keep[..., None], vals, zero) \
                * sorted_gate[..., None]
            return torch.zeros((c, T, D), dtype=cd,
                               device=out_buf.device).index_put(
                (ci, tok), vals.to(cd), accumulate=True).reshape(c, b, s, D)

        whole = L.chain_only(4)
        book = L.chain_only(2)
        buf, aux, *rest = L.region(
            dispatch, (x, self.router), (whole, L.chain_only(3)),
            [whole, L.chain_only(1)] + [book] * 5)
        w = [L.weight(t, cd) for t in (self.w_gate, self.w_up, self.w_down)]
        ep = L.moe_ep and L.fits(E)
        dp_cap = spec_entry(L.dp) if L.dp and L.fits(cap, L.dp) else None
        slots_spec = (whole[0], "model" if ep else None, dp_cap, None)
        w_spec = (whole[0], "model" if ep else None, None, None)
        out_buf = L.region(experts, (buf, *w), (slots_spec, w_spec, w_spec,
                                                 w_spec), slots_spec)
        y = L.region(combine, (out_buf, *rest), (whole,) + (book,) * 5,
                     whole)
        y = L.put(y, L.act(4))
        if self.dense is not None:                         # Arctic residual
            y = y + self.dense(x, cd, L)
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
