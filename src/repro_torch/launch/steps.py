"""The LM train / prefill / decode steps, built per (arch × dist)
config, the reference's `launch.steps`.

train_step: per-chain loss, `backward` on the sum over chains (the chains
share no parameter, so each chain's gradient is its own loss's),
microbatch gradient accumulation in float32, per-chain clipping and
AdamW.  Nothing reduces over the chain dim.

decode_step: optionally combines the per-chain logits with the paper's
Simple or Weighted Average (the serving-time ensemble, Eq. 6).

Each builder takes an optional `mesh`: then the model's parameters, the
optimizer state, the batch and the cache are DTensors placed by
`launch.sharding`'s rules (`shard_model`, `shard_tree`), the step runs
the plain route (`use_kernels=False`) with the layout of `dist` on the
mesh, and its outputs are DTensors too.  Without a mesh every tensor is
a plain tensor on one device.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, loss_fn
from repro_torch.models.layout import is_dtensor
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import leaves_with_paths, map_with_paths
from .sharding import DistConfig, layout as make_layout

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _split(x, a):
    """[C, B, ...] → [A, C, B/A, ...], microbatch-major."""
    c, b = x.shape[:2]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    return x.reshape((c, a, b // a) + tuple(x.shape[2:])).movedim(1, 0)


def _microbatches(x, a, L):
    """x [C, B, ...] as A microbatches [C, B/A, ...] of consecutive rows
    (`_split`).  A DTensor batch is gathered over the data-parallel axes
    first, and each microbatch split over them again where its rows
    divide (else it is whole on every device of its chain)."""
    if not is_dtensor(x):
        return _split(x, a)
    mbs = _split(L.put(x, L.chain_only(x.ndim)), a)
    spec = L.act(x.ndim) if L.fits(x.shape[1] // a, L.dp) \
        else L.chain_only(x.ndim)
    return [L.put(mbs[i], spec) for i in range(a)]


def _check_chains(dist: DistConfig, tokens):
    if tokens.shape[0] != dist.n_chains:
        raise ValueError(f"a batch of {tokens.shape[0]} chains under "
                         f"DistConfig(n_chains={dist.n_chains})")


def _layout(dist: DistConfig, mesh):
    if mesh is not None and dist.use_kernels:
        raise ValueError("the sharded steps take the plain route: "
                         "DistConfig(use_kernels=False)")
    return make_layout(mesh, dist)


def _grad_of(p):
    """p's gradient in p's own placement (a DTensor's gradient may come
    back partial over the data-parallel axes: reduced here, within the
    chain's devices)."""
    g = p.grad
    if is_dtensor(g) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, dist: DistConfig, opt: OptConfig,
                    mesh=None):
    """train_step(model, opt_state, batch) → (model, opt_state, metrics):
    the model's weights and the state's moments are updated in place;
    metrics "loss" and "grad_norm" [C], "lr".  batch: {"tokens",
    "targets" [C, B, S], optional "embeds"} on the model's device.  The
    backward pass seeds every chain's loss with one, the gradient of
    their sum.  The optimizer state's dtype is named twice, as in the
    reference (`dist.opt_dtype`, which the dry-run's rules read, and
    `opt.opt_dtype`, which AdamW reads): the two must agree."""
    if dist.opt_dtype != opt.opt_dtype:
        raise ValueError(f"DistConfig(opt_dtype={dist.opt_dtype!r}) and "
                         f"OptConfig(opt_dtype={opt.opt_dtype!r}) differ")
    cd = DTYPES[dist.compute_dtype]
    remat = dist.remat_policy if dist.remat else False
    L = _layout(dist, mesh)

    def per_chain(model, mb):
        loss = loss_fn(model, mb, compute_dtype=cd,
                       use_kernels=dist.use_kernels, remat=remat, layout=L)
        return L.put(loss, L.chain_only(1))

    def train_step(model, opt_state, batch):
        _check_chains(dist, batch["tokens"])
        params = model.param_tree()
        a = dist.accum_steps
        model.zero_grad(set_to_none=True)
        if a == 1:
            loss = per_chain(model, batch)
            loss.backward(torch.ones_like(loss))
            grads = map_with_paths(lambda _, p: _grad_of(p), params)
        else:
            mbs = {k: _microbatches(v, a, L) for k, v in batch.items()}
            flat = [p for _, p in leaves_with_paths(params)]
            acc, loss = None, 0
            for i in range(a):
                part = per_chain(model, {k: v[i] for k, v in mbs.items()})
                part.backward(torch.ones_like(part))
                # float32 sums that start as a copy of the first
                # microbatch's gradients: each device's own buffer (a
                # zero buffer made from a replicated DTensor parameter is
                # one tensor for all ranks under LocalTensorMode)
                if acc is None:
                    acc = [_grad_of(p).to(
                        torch.float32, copy=True,
                        memory_format=torch.contiguous_format) for p in flat]
                else:
                    for g, p in zip(acc, flat):
                        g.add_(_grad_of(p))
                model.zero_grad(set_to_none=True)
                loss = loss + part.detach()
            it = iter(g.div_(a) for g in acc)
            grads = map_with_paths(lambda _, p: next(it), params)
            loss = loss / a
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt)
        model.zero_grad(set_to_none=True)
        metrics["loss"] = loss.detach()
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, dist: DistConfig, mesh=None):
    """prefill_step(model, batch) → logits: one forward pass over the
    prompts (the last position's only with `opt_prefill_last_only`)."""
    cd = DTYPES[dist.compute_dtype]
    L = _layout(dist, mesh)

    @torch.no_grad()
    def prefill_step(model, batch):
        _check_chains(dist, batch["tokens"])
        return model(batch["tokens"], batch.get("embeds"), compute_dtype=cd,
                     use_kernels=dist.use_kernels,
                     last_token_only=dist.opt_prefill_last_only, layout=L)

    return prefill_step


def make_decode_step(cfg: ModelConfig, dist: DistConfig,
                     combine: str = "none", mesh=None):
    """decode_step(model, cache, batch) → (logits, cache).  combine:
    "none" (per-chain logits [C, b, 1, V]) | "simple" | "weighted" (the
    log of the chains' mixed next-token distribution [b, 1, V]; weighted
    reads batch["chain_weights"] [C], e.g. inverse validation loss, the
    LM analogue of the paper's inverse training MSE)."""
    if combine not in ("none", "simple", "weighted"):
        raise ValueError(f"combine={combine!r}")
    cd = DTYPES[dist.compute_dtype]
    L = _layout(dist, mesh)

    @torch.no_grad()
    def step(model, cache, batch):
        _check_chains(dist, batch["tokens"])
        logits, new_cache = model.decode_step(
            cache, batch["tokens"], batch.get("embeds"), compute_dtype=cd,
            use_kernels=dist.use_kernels, layout=L)
        if combine == "none":
            return logits, new_cache
        probs = torch.softmax(logits.float(), dim=-1)
        if combine == "simple":
            mix = probs.mean(0)                                  # Eq. (7)
        else:
            w = batch["chain_weights"].float()
            w = w / w.sum().clamp(min=1e-9)
            mix = torch.einsum("c,cbsv->bsv", w, probs)         # Eq. (9)
        return torch.log(mix.clamp(min=1e-30)), new_cache

    return step
