"""AdamW with per-chain semantics, the reference's `optim.adamw`.

Every parameter leaf is [n_chains, ...] (a stacked `layers_stacked` leaf
[L, n_chains, ...]); every optimizer statistic keeps that chain dim, and
every reduction (the clipping norm, the metrics) is per chain: nothing
crosses the chain axis, which keeps the paper's communication-free
property at the optimizer level.

Trees are the reference's nested dicts and lists (`Transformer.
param_tree()`), the leaves tensors.  `adamw_update` writes the new
parameters and moments into their leaves in place, leaf by leaf and
chain by chain, the arithmetic in float32 whatever the leaves' dtype:
one chain of one leaf's temporaries at a time is all the memory it
adds.  Included, as in the reference: low-precision optimizer state
(`opt_dtype="bfloat16"` halves m and v), stochastic-rounding gradient
quantization (`quantize_grads`, a function that no step calls: the
reference's `grad_quant_bits` has no reader either, so OptConfig leaves
it out), decoupled weight decay and a
warmup-cosine schedule.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import torch

from repro_torch.tree import leaves_with_paths, map_with_paths

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    opt_dtype: str = "float32"       # "bfloat16" halves optimizer state


def lr_schedule(cfg: OptConfig, step):
    """The learning rate at `step` (an int or an int tensor), float32:
    linear warmup to `lr`, then a cosine down to `min_lr_frac · lr`."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig):
    """Zero moments of each leaf's shape in `opt_dtype`, and step 0 (an
    int32 scalar), on the leaves' device."""
    dt = DTYPES[cfg.opt_dtype]

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = leaves_with_paths(params)[0][1].device
    return {"m": map_with_paths(zeros, params),
            "v": map_with_paths(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chain_axis(path: str) -> int:
    """A stacked leaf (under `layers_stacked`) has the layer dim first."""
    return 1 if "['layers_stacked']" in path else 0


def _per_chain_sq(path, g):
    """Sum of squares per chain: [..., C, ...] → [C], in float32."""
    ax = _chain_axis(path)
    dims = tuple(i for i in range(g.ndim) if i != ax)
    return g.float().square().sum(dim=dims)


def global_norm_per_chain(grads):
    """Each chain's gradient norm over every leaf, [C]."""
    return torch.sqrt(sum(_per_chain_sq(path, g)
                          for path, g in leaves_with_paths(grads)))


def _clip_scale(norm, clip_norm):
    return torch.clamp(clip_norm / (norm + 1e-9), max=1.0)


def _along(scale, path, ndim):
    shape = [1] * ndim
    shape[_chain_axis(path)] = -1
    return scale.reshape(shape)


def clip_by_global_norm_per_chain(grads, clip_norm):
    """(grads each chain scaled to a norm of at most `clip_norm`, the
    per-chain norms before clipping [C])."""
    norm = global_norm_per_chain(grads)
    scale = _clip_scale(norm, clip_norm)

    def apply(path, g):
        return (g.float() * _along(scale, path, g.ndim)).to(g.dtype)
    return map_with_paths(apply, grads), norm


def quantize_grads(grads, seed: int, bits: int = 8):
    """Per-tensor-scale stochastic-rounding quantization: each leaf
    rounded to a grid of max|g| / (2^(bits-1) - 1) after uniform noise in
    [-1/2, 1/2) steps, so the error is at most one step and its mean is
    zero.  Each leaf's noise comes from a torch generator seeded by
    `seed` and the CRC-32 of the leaf's path, the same in every process
    (the reference's `hash(str(path))` changes from one process to the
    next)."""
    qmax = 2.0 ** (bits - 1) - 1

    def q(path, g):
        gen = torch.Generator(device=g.device).manual_seed(
            (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % 2 ** 63)
        gf = g.float()
        scale = gf.abs().max().clamp(min=1e-12) / qmax
        noise = torch.rand(g.shape, generator=gen, device=g.device) - 0.5
        return (torch.round(gf / scale + noise) * scale).to(g.dtype)
    return map_with_paths(q, grads)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step with per-chain gradient clipping, written into the
    leaves of `params` and of `state`'s m and v.  Returns (params, the
    state with step + 1, {"grad_norm": the per-chain norms before
    clipping [C], "lr"})."""
    flat = leaves_with_paths(params)
    flat_g = [g for _, g in leaves_with_paths(grads)]
    flat_m = [m for _, m in leaves_with_paths(state["m"])]
    flat_v = [v for _, v in leaves_with_paths(state["v"])]
    norm = global_norm_per_chain(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for (path, p), g, m, v in zip(flat, flat_g, flat_m, flat_v):
        ax = _chain_axis(path)
        for c in range(p.shape[ax]):
            pc, gc, mc, vc = (t.select(ax, c) for t in (p, g, m, v))
            gf = (gc.float() * scale[c]).to(gc.dtype).float()
            mf = b1 * mc.float() + (1 - b1) * gf
            vf = b2 * vc.float() + (1 - b2) * gf.square()
            delta = (mf / bc1) / ((vf / bc2).sqrt() + cfg.eps) \
                + cfg.weight_decay * pc.float()
            pc.copy_(pc.float() - lr * delta)
            mc.copy_(mf)
            vc.copy_(vf)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": norm, "lr": lr}
