"""The decoder of the LM zoo: the reference's `init_params` / `forward`
/ `init_cache` / `decode_step` for `'A'` (attention + MLP) and `'M'`
(Mamba-2) layers and the hybrid's parameter-shared attention block, as
modules whose parameters keep the reference's leading chain axis
`[C, ...]`.

Chains are the paper's communication-free ensemble axis: nothing in this
module reduces across them.  MoE and the modality frontends raise
`NotImplementedError` until the ROADMAP item that brings them (queue A
item 15).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from .attention import Attention, init_kv_cache
from .config import ModelConfig
from .layers import MLP, Init, embed, param, rmsnorm, unembed
from .ssm import Mamba, init_ssm_cache


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's models do not run yet."""
    missing = []
    if cfg.n_experts > 0:
        missing.append("MoE layers")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} come with ROADMAP queue A "
            "item 15")


class Block(nn.Module):
    """Pre-norm attention + SwiGLU MLP, both residual."""

    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.eps = cfg.norm_eps
        D = cfg.d_model
        self.norm1 = param(init.full(1.0, (n_chains, D), torch.float32))
        self.attn = Attention(cfg, n_chains, dtype, init)
        self.norm2 = param(init.full(1.0, (n_chains, D), torch.float32))
        self.mlp = MLP(D, cfg.d_ff, n_chains, dtype, init)

    def forward(self, x, positions, cache=None, *, compute_dtype):
        cd = compute_dtype
        h, cache = self.attn(rmsnorm(x, self.norm1, self.eps).to(cd),
                             positions, cache, compute_dtype=cd)
        x = x + h
        x = x + self.mlp(rmsnorm(x, self.norm2, self.eps).to(cd), cd)
        return x, cache


class MambaBlock(nn.Module):
    """Pre-norm Mamba-2 mixer, residual."""

    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.eps = cfg.norm_eps
        self.norm1 = param(init.full(1.0, (n_chains, cfg.d_model),
                                     torch.float32))
        self.mamba = Mamba(cfg, n_chains, dtype, init)

    def forward(self, x, positions, cache=None, *, compute_dtype):
        """As `Block.forward`; the positions are not read."""
        h, cache = self.mamba(rmsnorm(x, self.norm1, self.eps)
                              .to(compute_dtype), cache,
                              compute_dtype=compute_dtype)
        return x + h, cache


LAYERS = {"A": Block, "M": MambaBlock}


class Transformer(nn.Module):
    """The model of `cfg` for `n_chains` independent chains."""

    def __init__(self, cfg: ModelConfig, n_chains: int = 1,
                 param_dtype=torch.float32, *, init: Init):
        super().__init__()
        check_supported(cfg)
        self.cfg, self.n_chains = cfg, n_chains
        C, D, V = n_chains, cfg.d_model, cfg.vocab_size
        self.embed = param(init.dense(1, (C, V, D), param_dtype))
        self.final_norm = param(init.full(1.0, (C, D), torch.float32))
        self.lm_head = None if cfg.tie_embeddings else param(
            init.dense(D, (C, D, V), param_dtype))
        self.layers = nn.ModuleList(LAYERS[kind](cfg, C, param_dtype, init)
                                    for kind in cfg.pattern)
        # the hybrid's one attention + MLP block, applied after every
        # `shared_attn_every`-th layer with a KV cache per application
        self.shared = (Block(cfg, C, param_dtype, init)
                       if cfg.shared_attn_every else None)

    def _shared_after(self, i):
        return self.shared is not None and \
            (i + 1) % self.cfg.shared_attn_every == 0

    def _logits(self, x, cd):
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps).to(cd)
        if self.lm_head is None:
            return unembed(self.embed, x, cd)
        return torch.einsum("cbsd,cdv->cbsv", x, self.lm_head.to(cd))

    def forward(self, tokens, *, compute_dtype=torch.bfloat16,
                last_token_only=False):
        """tokens [c, b, s] → logits [c, b, s, V], causal over s; with
        `last_token_only` only the last position's [c, b, 1, V] (the
        serving prefill: no [b, s, V] logits tensor)."""
        x = embed(self.embed, tokens, compute_dtype)
        c, b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(c, b, s)
        for i, blk in enumerate(self.layers):
            x, _ = blk(x, positions, compute_dtype=compute_dtype)
            if self._shared_after(i):
                x, _ = self.shared(x, positions, compute_dtype=compute_dtype)
        if last_token_only:
            x = x[:, :, -1:]
        return self._logits(x, compute_dtype)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        cfg, C, dev = self.cfg, self.n_chains, self.final_norm.device

        def kv():
            return init_kv_cache(cfg, C, batch, max_len, dtype, dev)
        cache = {"layers": [kv() if kind == "A" else
                            init_ssm_cache(cfg, C, batch, dtype, dev)
                            for kind in cfg.pattern],
                 "pos": torch.zeros((C, batch), dtype=torch.int32,
                                    device=dev)}
        if self.shared is not None:
            cache["shared"] = [kv() for _ in range(
                cfg.n_layers // cfg.shared_attn_every)]
        return cache

    def decode_step(self, cache, tokens, *, compute_dtype=torch.bfloat16):
        """One token per (chain, slot): tokens [c, b, 1] → (logits
        [c, b, 1, V], cache).  The K/V caches are written in place; an
        `'M'` layer's cache is replaced."""
        x = embed(self.embed, tokens, compute_dtype)
        positions = cache["pos"][:, :, None]
        layers, shared = [], []
        for i, (blk, lc) in enumerate(zip(self.layers, cache["layers"])):
            x, lc = blk(x, positions, lc, compute_dtype=compute_dtype)
            layers.append(lc)
            if self._shared_after(i):
                x, sc = self.shared(x, positions, cache["shared"][len(shared)],
                                    compute_dtype=compute_dtype)
                shared.append(sc)
        new = {"layers": layers, "pos": cache["pos"] + 1}
        if self.shared is not None:
            new["shared"] = shared
        return self._logits(x, compute_dtype), new


def init_params(cfg: ModelConfig, n_chains: int = 1,
                param_dtype=torch.float32, *, seed: int = 0, device="cuda",
                generator=None) -> Transformer:
    """A model with random weights.  They are drawn on `generator`, by
    default a CPU generator seeded with `seed` (so one seed names one
    model on every device), and moved to `device`; a generator on the
    card draws a full-width model faster."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return Transformer(cfg, n_chains, param_dtype,
                       init=Init(dev, generator))

