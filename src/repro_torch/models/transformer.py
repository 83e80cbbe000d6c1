"""The decoder of the LM zoo: the reference's `init_params` / `forward`
/ `loss_fn` / `init_cache` / `decode_step` for `'A'` layers (attention
and an MLP, or a top-k MoE when `cfg.is_moe`), `'M'` (Mamba-2) layers,
the hybrid's parameter-shared attention block and the stub modality
frontends (one projection of precomputed embeddings: vision prepends
them, audio adds them frame by frame), as modules whose parameters keep
the reference's leading chain axis `[C, ...]`.

Chains are the paper's communication-free ensemble axis: nothing in this
module reduces across them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from .attention import Attention, init_kv_cache
from .config import ModelConfig
from .layers import MLP, Init, cross_entropy, embed, param, rmsnorm, unembed
from .layout import PLAIN
from .moe import MoE
from .ssm import Mamba, init_ssm_cache


class Block(nn.Module):
    """Pre-norm attention + SwiGLU MLP (or MoE), both residual.  The
    hybrid's shared block is always an MLP block (`moe=False`)."""

    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init,
                 moe=None):
        super().__init__()
        self.eps = cfg.norm_eps
        D = cfg.d_model
        self.norm1 = param(init.full(1.0, (n_chains, D), torch.float32))
        self.attn = Attention(cfg, n_chains, dtype, init)
        self.norm2 = param(init.full(1.0, (n_chains, D), torch.float32))
        if cfg.is_moe if moe is None else moe:
            self.moe = MoE(cfg, n_chains, dtype, init)
        else:
            self.mlp = MLP(D, cfg.d_ff, n_chains, dtype, init)

    def forward(self, x, positions, cache=None, *, compute_dtype,
                use_kernels=True, layout=PLAIN):
        """Returns (x, the cache, the MoE's aux loss [c] or None)."""
        cd, uk = compute_dtype, use_kernels
        h, cache = self.attn(rmsnorm(x, self.norm1, self.eps, uk).to(cd),
                             positions, cache, compute_dtype=cd,
                             use_kernels=uk, layout=layout)
        x = x + h
        inner = rmsnorm(x, self.norm2, self.eps, uk).to(cd)
        if hasattr(self, "moe"):
            h, aux = self.moe(inner, cd, layout)
            return x + h, cache, aux
        return x + self.mlp(inner, cd, layout), cache, None


class MambaBlock(nn.Module):
    """Pre-norm Mamba-2 mixer, residual."""

    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.eps = cfg.norm_eps
        self.norm1 = param(init.full(1.0, (n_chains, cfg.d_model),
                                     torch.float32))
        self.mamba = Mamba(cfg, n_chains, dtype, init)

    def forward(self, x, positions, cache=None, *, compute_dtype,
                use_kernels=True, layout=PLAIN):
        """As `Block.forward`; the positions are not read."""
        h, cache = self.mamba(rmsnorm(x, self.norm1, self.eps, use_kernels)
                              .to(compute_dtype), cache,
                              compute_dtype=compute_dtype,
                              use_kernels=use_kernels, layout=layout)
        return x + h, cache, None


LAYERS = {"A": Block, "M": MambaBlock}
# the matmuls whose outputs remat "dots" keeps (every einsum of a layer
# lowers to one of these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _remat(fn, policy, *args):
    """fn(*args) under activation checkpointing: "full" recomputes the
    whole layer in the backward pass; "dots" saves the matmul outputs
    and recomputes the rest."""
    if policy == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    list(_DOTS))
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context)
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


class Transformer(nn.Module):
    """The model of `cfg` for `n_chains` independent chains."""

    def __init__(self, cfg: ModelConfig, n_chains: int = 1,
                 param_dtype=torch.float32, *, init: Init):
        super().__init__()
        self.cfg, self.n_chains = cfg, n_chains
        C, D, V = n_chains, cfg.d_model, cfg.vocab_size
        self.embed = param(init.dense(1, (C, V, D), param_dtype))
        self.final_norm = param(init.full(1.0, (C, D), torch.float32))
        self.lm_head = None if cfg.tie_embeddings else param(
            init.dense(D, (C, D, V), param_dtype))
        # the stub frontend: one projection of precomputed embeddings
        self.frontend_proj = None if cfg.frontend == "none" else param(
            init.dense(D, (C, D, D), param_dtype))
        self.layers = nn.ModuleList(LAYERS[kind](cfg, C, param_dtype, init)
                                    for kind in cfg.pattern)
        # the hybrid's one attention + MLP block, applied after every
        # `shared_attn_every`-th layer with a KV cache per application
        self.shared = (Block(cfg, C, param_dtype, init, moe=False)
                       if cfg.shared_attn_every else None)
        if init.trainable:
            self.requires_grad_(True)

    def _shared_after(self, i):
        return self.shared is not None and \
            (i + 1) % self.cfg.shared_attn_every == 0

    def _logits(self, x, cd, use_kernels=True, layout=PLAIN):
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps, use_kernels).to(cd)
        if self.lm_head is None:
            return unembed(self.embed, x, cd, layout)
        return layout.proj("cbsd,cdv->cbsv", x, self.lm_head, cd)

    def _project(self, embeds, cd, layout=PLAIN):
        """Precomputed embeddings [c, b, p, D] through the frontend's
        projection."""
        emb = layout.proj("cbpd,cde->cbpe", embeds.to(cd),
                          self.frontend_proj, cd)
        return layout.put(emb, layout.act(4))

    def forward(self, tokens, embeds=None, *, compute_dtype=torch.bfloat16,
                use_kernels=True, remat=False, last_token_only=False,
                with_aux=False, layout=PLAIN):
        """tokens [c, b, s] → logits [c, b, s, V], causal over s.

        embeds: a frontend's precomputed embeddings, projected: vision's
        [c, b, n_patches, D] are prepended (positions run over the
        concatenation, logits cover the text positions only), audio's
        [c, b, s, D] are added frame by frame; None runs the text alone.
        `use_kernels` false runs every kernel's plain version (the route
        for autograd).  `remat` checkpoints each layer's activations:
        True or "full" recomputes the layer in the backward pass, "dots"
        keeps its matmul outputs.  `last_token_only` returns only the last
        position's [c, b, 1, V] (the serving prefill: no [b, s, V] logits
        tensor).  `with_aux` also returns the MoE layers' aux loss summed,
        [c] (zeros without MoE).  `layout` places the activations of a
        sharded model (`launch.sharding`)."""
        cd, uk = compute_dtype, use_kernels
        x = embed(self.embed, tokens, cd, layout)
        if embeds is not None:
            emb = self._project(embeds, cd, layout)
            x = torch.cat([emb, x], dim=2) if self.cfg.frontend == "vision" \
                else x + emb
        s = x.shape[2]
        aux = None
        policy = "full" if remat is True else remat

        def run(blk, x):
            # positions None: 0..s-1, made where they are read
            x, _, a = blk(x, None, compute_dtype=cd, use_kernels=uk,
                          layout=layout)
            return x, a

        blocks = []
        for i, blk in enumerate(self.layers):
            blocks += [blk, self.shared] if self._shared_after(i) else [blk]
        for blk in blocks:
            fn = functools.partial(run, blk)
            x, a = _remat(fn, policy, x) if policy else fn(x)
            if a is not None:
                aux = a if aux is None else aux + a
        x = x[:, :, s - tokens.shape[2]:]          # the text positions
        if last_token_only:
            x = x[:, :, -1:]
        logits = self._logits(x, cd, uk, layout)
        if aux is None and with_aux:
            aux = torch.zeros(x.shape[0], dtype=torch.float32,
                              device=x.device)
        return (logits, aux) if with_aux else logits

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

    def decode_step(self, cache, tokens, embeds=None, *,
                    compute_dtype=torch.bfloat16, use_kernels=True,
                    layout=PLAIN):
        """One token per (chain, slot): tokens [c, b, 1] → (logits
        [c, b, 1, V], cache).  `embeds` [c, b, 1, D], an audio frame's
        conditioning, is projected and added, as the reference does.  The
        K/V caches are written in place; an `'M'` layer's cache is
        replaced."""
        cd, uk, L = compute_dtype, use_kernels, layout
        x = embed(self.embed, tokens, cd, L)
        if embeds is not None:
            x = x + self._project(embeds, cd, L)
        positions = cache["pos"][:, :, None]
        layers, shared = [], []
        for i, (blk, lc) in enumerate(zip(self.layers, cache["layers"])):
            x, lc, _ = blk(x, positions, lc, compute_dtype=cd,
                           use_kernels=uk, layout=L)
            layers.append(lc)
            if self._shared_after(i):
                x, sc, _ = self.shared(x, positions,
                                       cache["shared"][len(shared)],
                                       compute_dtype=cd, use_kernels=uk,
                                       layout=L)
                shared.append(sc)
        new = {"layers": layers, "pos": cache["pos"] + 1}
        if self.shared is not None:
            new["shared"] = shared
        return self._logits(x, cd, uk, L), new

    def param_tree(self):
        """The weights as the reference's parameter tree (its list
        layout: `embed.table`, `layers[i]`, ...; a `scan_layers` config's
        too), the leaves this model's own parameters.  The optimizer
        state and checkpoints use this layout."""
        return nest(self.named_parameters())


def nest(named):
    """(parameter name, value) pairs → the reference's tree layout: the
    dotted name is the path (a digit a list index), `embed` is
    `embed.table`."""
    tree = {}
    for name, value in named:
        keys = ["embed", "table"] if name == "embed" else name.split(".")
        node = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            if k.isdigit():
                k = int(k)
                while len(node) <= k:
                    node.append({})
            elif k not in node:
                node[k] = [] if nxt.isdigit() else {}
            node = node[k]
        node[keys[-1]] = value
    return tree


def loss_fn(model, batch, *, compute_dtype=torch.bfloat16, use_kernels=True,
            remat=False, layout=PLAIN):
    """Per-chain loss [c], never reduced across chains: the
    cross-entropy of batch {"tokens", "targets" [c, b, s], optional
    "embeds"}, plus `router_aux_weight` · the MoE aux loss."""
    logits, aux = model(batch["tokens"], batch.get("embeds"),
                        compute_dtype=compute_dtype, use_kernels=use_kernels,
                        remat=remat, with_aux=True, layout=layout)
    ce = cross_entropy(logits, batch["targets"], layout=layout)
    return ce + model.cfg.router_aux_weight * aux if model.cfg.is_moe \
        else ce


def init_params(cfg: ModelConfig, n_chains: int = 1,
                param_dtype=torch.float32, *, seed: int = 0, device="cuda",
                generator=None, trainable=False) -> Transformer:
    """A model with random weights.  They are drawn on `generator`, by
    default a CPU generator seeded with `seed` (so one seed names one
    model on every device), and moved to `device`; a generator on the
    card draws a full-width model faster.  `trainable` turns gradients
    on."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return Transformer(cfg, n_chains, param_dtype,
                       init=Init(dev, generator, trainable=trainable))
