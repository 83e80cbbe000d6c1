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
from .layout import PLAIN


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
                use_kernels=True, layout=PLAIN):
        """x [c, b, s, D]; positions [c, b, s], or None for 0..s-1 in
        every row.  cache None (causal over the s positions) or {"k",
        "v": [c, b, Hkv, S, hd], "len": int32 [c, b]} for one token
        (s = 1), written in place at `len`.  `use_kernels` false runs B5
        and B7's plain versions.  Under a sharded `layout` the heads stay
        sharded over `model` where the projections left them head-aligned
        (Hkv divisible by the axis), kv heads are repeated to shard q's
        heads under `head_shard`, and otherwise q, k and v are gathered
        over `model` for the attention itself.  Returns (out [c, b, s, D],
        the cache with `len` + 1 or None)."""
        cfg, cd, L = self.cfg, compute_dtype, layout
        c, b, s, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = L.proj("cbsd,cdh->cbsh", x, self.wq, cd)
        k = L.proj("cbsd,cdh->cbsh", x, self.wk, cd)
        v = L.proj("cbsd,cdh->cbsh", x, self.wv, cd)
        if cfg.qkv_bias:
            q = q + L.weight(self.bq, cd)[:, None, None]
            k = k + L.weight(self.bk, cd)[:, None, None]
            v = v + L.weight(self.bv, cd)[:, None, None]
        m = L.msize
        heads = m == 1 or Hkv % m == 0
        if not heads and L.head_shard and cache is None and H % m == 0:
            # each kv head repeated for its q heads (k, v whole over
            # `model` first): GQA becomes MHA, whose heads shard like q's
            k, v = (L.put(t, L.act(4)).reshape(c, b, s, Hkv, 1, hd)
                    .expand(c, b, s, Hkv, H // Hkv, hd)
                    .reshape(c, b, s, H * hd) for t in (k, v))
            heads = True
        act = L.act(4, 3 if heads else None)
        qn = getattr(self, "q_norm", None)
        kn = getattr(self, "k_norm", None)
        norm_spec = L.chain_only(2)
        switches = dict(causal_skip=L.causal_skip, block_q=L.block_q,
                        probs_bf16=L.probs_bf16)

        def core(q, k, v, qn, kn, positions, *kv):
            # local shards: [c, b, s, h * hd] with h this shard's heads
            c, b = q.shape[:2]
            q = q.reshape(c, b, s, -1, hd)
            k = k.reshape(c, b, s, -1, hd)
            v = v.reshape(c, b, s, -1, hd)
            if cfg.qk_norm:
                q = rmsnorm(q, qn, cfg.norm_eps, use_kernels).to(cd)
                k = rmsnorm(k, kn, cfg.norm_eps, use_kernels).to(cd)
            if positions is None:
                positions = torch.arange(s, dtype=torch.int32,
                                         device=q.device).expand(c, b, s)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            h, hk = q.shape[3], k.shape[3]

            # [c, b, s, h, hd] → [(c b), h, s, hd], the kernel's layout
            def fold(t):
                return t.transpose(2, 3).reshape(c * b, t.shape[3], s, hd)

            if not kv:
                out = ops.attention(fold(q), fold(k), fold(v), causal=True,
                                    use_kernels=use_kernels, **switches)
                kc = vc = None
            else:
                kc, vc, idx = kv
                ci = torch.arange(c, device=q.device)[:, None]
                bi = torch.arange(b, device=q.device)[None, :]
                kc[ci, bi, :, idx] = k[:, :, 0].to(kc.dtype)     # [c,b,hk,hd]
                vc[ci, bi, :, idx] = v[:, :, 0].to(vc.dtype)
                S = kc.shape[3]
                out = ops.attention(
                    fold(q), kc.reshape(c * b, hk, S, hd).to(cd),
                    vc.reshape(c * b, hk, S, hd).to(cd), causal=True,
                    kv_len=(idx + 1).reshape(c * b),
                    use_kernels=use_kernels, **switches)
            out = out.reshape(c, b, h, s, hd).transpose(2, 3).reshape(
                c, b, s, h * hd)
            return out, kc, vc

        new_cache = None
        if cache is None:
            out, _, _ = L.region(core, (q, k, v, qn, kn, positions),
                                 (act, act, act, norm_spec, norm_spec,
                                  L.act(3)), [act, None, None])
        else:
            if s != 1:
                raise ValueError(f"the cached path takes one token a step, "
                                 f"got {s}")
            kv_spec = L.act(5, 2 if heads else None)
            out, kc, vc = L.region(
                core, (q, k, v, qn, kn, positions, cache["k"], cache["v"],
                       cache["len"]),
                (act, act, act, norm_spec, norm_spec, L.act(3), kv_spec,
                 kv_spec, L.act(2)), [act, kv_spec, kv_spec])
            # back to the cache's own placement (a local slice)
            kc, vc = L.put_like(kc, cache["k"]), L.put_like(vc, cache["v"])
            new_cache = {"k": kc, "v": vc, "len": cache["len"] + 1}
        return L.proj("cbsh,chd->cbsd", out, self.wo, cd), new_cache


def init_kv_cache(cfg: ModelConfig, n_chains, batch, max_len, dtype, device):
    shape = (n_chains, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": torch.zeros((n_chains, batch), dtype=torch.int32,
                               device=device)}
