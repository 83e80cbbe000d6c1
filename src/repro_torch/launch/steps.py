"""The LM train / prefill / decode steps, built per (arch × dist)
config, the reference's `launch.steps`.

train_step: per-chain loss, `backward` on the sum over chains (the chains
share no parameter, so each chain's gradient is its own loss's),
microbatch gradient accumulation in float32, per-chain clipping and
AdamW.  Nothing reduces over the chain dim.

decode_step: optionally combines the per-chain logits with the paper's
Simple or Weighted Average (the serving-time ensemble, Eq. 6).
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, loss_fn
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.tree import leaves_with_paths, map_with_paths
from .sharding import DistConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _split(x, a):
    """[C, B, ...] → [A, C, B/A, ...], microbatch-major."""
    c, b = x.shape[:2]
    if b % a:
        raise ValueError(f"batch {b} does not split into {a} microbatches")
    return x.reshape((c, a, b // a) + tuple(x.shape[2:])).movedim(1, 0)


def _check_chains(dist: DistConfig, tokens):
    if tokens.shape[0] != dist.n_chains:
        raise ValueError(f"a batch of {tokens.shape[0]} chains under "
                         f"DistConfig(n_chains={dist.n_chains})")


def make_train_step(cfg: ModelConfig, dist: DistConfig, opt: OptConfig):
    """train_step(model, opt_state, batch) → (model, opt_state, metrics):
    the model's weights and the state's moments are updated in place;
    metrics "loss" and "grad_norm" [C], "lr".  batch: {"tokens",
    "targets" [C, B, S], optional "embeds"} on the model's device."""
    cd = DTYPES[dist.compute_dtype]
    remat = dist.remat_policy if dist.remat else False

    def per_chain(model, mb):
        return loss_fn(model, mb, compute_dtype=cd,
                       use_kernels=dist.use_kernels, remat=remat)

    def train_step(model, opt_state, batch):
        _check_chains(dist, batch["tokens"])
        params = model.param_tree()
        a = dist.accum_steps
        model.zero_grad(set_to_none=True)
        if a == 1:
            loss = per_chain(model, batch)
            loss.sum().backward()
            grads = map_with_paths(lambda _, p: p.grad, params)
        else:
            mbs = {k: _split(v, a) for k, v in batch.items()}
            flat = [p for _, p in leaves_with_paths(params)]
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in flat]
            loss = 0
            for i in range(a):
                part = per_chain(model, {k: v[i] for k, v in mbs.items()})
                part.sum().backward()
                for g, p in zip(acc, flat):
                    g.add_(p.grad)
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


def make_prefill_step(cfg: ModelConfig, dist: DistConfig):
    """prefill_step(model, batch) → logits: one forward pass over the
    prompts (the last position's only with `opt_prefill_last_only`)."""
    cd = DTYPES[dist.compute_dtype]

    @torch.no_grad()
    def prefill_step(model, batch):
        _check_chains(dist, batch["tokens"])
        return model(batch["tokens"], batch.get("embeds"), compute_dtype=cd,
                     use_kernels=dist.use_kernels,
                     last_token_only=dist.opt_prefill_last_only)

    return prefill_step


def make_decode_step(cfg: ModelConfig, dist: DistConfig,
                     combine: str = "none"):
    """decode_step(model, cache, batch) → (logits, cache).  combine:
    "none" (per-chain logits [C, b, 1, V]) | "simple" | "weighted" (the
    log of the chains' mixed next-token distribution [b, 1, V]; weighted
    reads batch["chain_weights"] [C], e.g. inverse validation loss, the
    LM analogue of the paper's inverse training MSE)."""
    if combine not in ("none", "simple", "weighted"):
        raise ValueError(f"combine={combine!r}")
    cd = DTYPES[dist.compute_dtype]

    @torch.no_grad()
    def step(model, cache, batch):
        _check_chains(dist, batch["tokens"])
        logits, new_cache = model.decode_step(
            cache, batch["tokens"], batch.get("embeds"), compute_dtype=cd,
            use_kernels=dist.use_kernels)
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
