"""GQA attention with RoPE, optional QKV bias (qwen2) and qk-norm (qwen3).
The full-sequence path runs causal attention over the prompt; the decode
path writes one token's K/V into the cache in place and attends to the
cache's valid prefix (kernel B5 on the card for both)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import Init, param, rmsnorm, rope


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.cfg = cfg
        C, D, H, Hkv, hd = (n_chains, cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd)
        self.wq = param(init.dense(D, (C, D, H * hd), dtype))
        self.wk = param(init.dense(D, (C, D, Hkv * hd), dtype))
        self.wv = param(init.dense(D, (C, D, Hkv * hd), dtype))
        self.wo = param(init.dense(H * hd, (C, H * hd, D), dtype))
        if cfg.qkv_bias:
            self.bq = param(init.full(0.0, (C, H * hd), dtype))
            self.bk = param(init.full(0.0, (C, Hkv * hd), dtype))
            self.bv = param(init.full(0.0, (C, Hkv * hd), dtype))
        if cfg.qk_norm:
            self.q_norm = param(init.full(1.0, (C, hd), torch.float32))
            self.k_norm = param(init.full(1.0, (C, hd), torch.float32))

    def forward(self, x, positions, cache=None, *, compute_dtype,
                use_kernels=True):
        """x [c, b, s, D]; positions [c, b, s].  cache None (causal over
        the s positions) or {"k", "v": [c, b, Hkv, S, hd], "len": int32
        [c, b]} for one token (s = 1), written in place at `len`.
        `use_kernels` false runs B5 and B7's plain versions.  Returns
        (out [c, b, s, D], the cache with `len` + 1 or None)."""
        cfg, cd = self.cfg, compute_dtype
        c, b, s, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = torch.einsum("cbsd,cdh->cbsh", x, self.wq.to(cd))
        k = torch.einsum("cbsd,cdh->cbsh", x, self.wk.to(cd))
        v = torch.einsum("cbsd,cdh->cbsh", x, self.wv.to(cd))
        if cfg.qkv_bias:
            q = q + self.bq.to(cd)[:, None, None]
            k = k + self.bk.to(cd)[:, None, None]
            v = v + self.bv.to(cd)[:, None, None]
        q = q.reshape(c, b, s, H, hd)
        k = k.reshape(c, b, s, Hkv, hd)
        v = v.reshape(c, b, s, Hkv, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.q_norm, cfg.norm_eps, use_kernels).to(cd)
            k = rmsnorm(k, self.k_norm, cfg.norm_eps, use_kernels).to(cd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

        # [c, b, s, h, hd] → [(c b), h, s, hd], the kernel's layout
        def fold(t):
            return t.transpose(2, 3).reshape(c * b, t.shape[3], s, hd)

        new_cache = None
        if cache is None:
            out = ops.attention(fold(q), fold(k), fold(v), causal=True,
                                use_kernels=use_kernels)
        else:
            if s != 1:
                raise ValueError(f"the cached path takes one token a step, "
                                 f"got {s}")
            idx = cache["len"]                                   # [c, b]
            ci = torch.arange(c, device=x.device)[:, None]
            bi = torch.arange(b, device=x.device)[None, :]
            kc, vc = cache["k"], cache["v"]
            kc[ci, bi, :, idx] = k[:, :, 0].to(kc.dtype)         # [c,b,Hkv,hd]
            vc[ci, bi, :, idx] = v[:, :, 0].to(vc.dtype)
            new_cache = {"k": kc, "v": vc, "len": idx + 1}
            S = kc.shape[3]
            out = ops.attention(
                fold(q), kc.reshape(c * b, Hkv, S, hd).to(cd),
                vc.reshape(c * b, Hkv, S, hd).to(cd), causal=True,
                kv_len=(idx + 1).reshape(c * b), use_kernels=use_kernels)
        out = out.reshape(c, b, H, s, hd).transpose(2, 3).reshape(
            c, b, s, H * hd)
        return torch.einsum("cbsh,chd->cbsd", out, self.wo.to(cd)), new_cache


def init_kv_cache(cfg: ModelConfig, n_chains, batch, max_len, dtype, device):
    shape = (n_chains, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((n_chains, batch), dtype=torch.int32,
                               device=device)}
