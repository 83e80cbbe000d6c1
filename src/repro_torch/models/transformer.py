"""The dense decoder of the LM zoo: the reference's `'A'` route of
`init_params` / `forward` / `init_cache` / `decode_step`, as modules whose
parameters keep the reference's leading chain axis `[C, ...]`.

Chains are the paper's communication-free ensemble axis: nothing in this
module reduces across them.  MoE, Mamba-2 layers, the shared attention
block and the modality frontends raise `NotImplementedError` until the
ROADMAP item that brings them (queue A item 15).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from .attention import Attention, init_kv_cache
from .config import ModelConfig
from .layers import MLP, Init, embed, param, rmsnorm, unembed


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's models do not run yet."""
    missing = []
    if cfg.n_experts > 0:
        missing.append("MoE layers")
    if "M" in cfg.pattern:
        missing.append("Mamba-2 layers (kernel B6)")
    if cfg.shared_attn_every:
        missing.append("the shared attention block")
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
        self.layers = nn.ModuleList(Block(cfg, C, param_dtype, init)
                                    for _ in range(cfg.n_layers))

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
        for blk in self.layers:
            x, _ = blk(x, positions, compute_dtype=compute_dtype)
        if last_token_only:
            x = x[:, :, -1:]
        return self._logits(x, compute_dtype)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        dev = self.final_norm.device
        return {"layers": [init_kv_cache(self.cfg, self.n_chains, batch,
                                         max_len, dtype, dev)
                           for _ in self.layers],
                "pos": torch.zeros((self.n_chains, batch), dtype=torch.int32,
                                   device=dev)}

    def decode_step(self, cache, tokens, *, compute_dtype=torch.bfloat16):
        """One token per (chain, slot): tokens [c, b, 1] → (logits
        [c, b, 1, V], cache).  The K/V caches are written in place."""
        x = embed(self.embed, tokens, compute_dtype)
        positions = cache["pos"][:, :, None]
        layers = []
        for blk, lc in zip(self.layers, cache["layers"]):
            x, lc = blk(x, positions, lc, compute_dtype=compute_dtype)
            layers.append(lc)
        return self._logits(x, compute_dtype), {"layers": layers,
                                                "pos": cache["pos"] + 1}


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

