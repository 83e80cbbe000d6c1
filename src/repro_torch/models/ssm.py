"""The Mamba-2 mixer (SSD) of the `'M'` layers: split input projections
(`wz` / `wx` / `wbc` / `wdt`, as the reference keeps them), a depthwise
causal conv with SiLU, the SSD scan over the sequence (kernel B6 on the
card, one launch covering every chain) or one step of its recurrence
with a `(conv_x, conv_bc, ssm)` cache in place of a KV cache, the gated
RMSNorm (kernel B7) and the output projection.  Parameters keep the
reference's names and leading chain axis `[C, ...]`.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops
from .config import ModelConfig
from .layers import Init, param, rmsnorm
from .layout import PLAIN


def _causal_conv(u, w, b):
    """Depthwise causal conv over s with SiLU.  u [c, b, s, ch]; w
    [c, K, ch]; b [c, ch]."""
    K, s = w.shape[1], u.shape[2]
    pad = F.pad(u, (0, 0, K - 1, 0))
    out = sum(pad[:, :, i:i + s, :] * w[:, None, None, i, :]
              for i in range(K))
    return F.silu(out + b[:, None, None, :])


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, n_chains: int, dtype, init: Init):
        super().__init__()
        self.cfg = cfg
        C, D, di = n_chains, cfg.d_model, cfg.d_inner
        N, H, Kc = cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
        self.wz = param(init.dense(D, (C, D, di), dtype))
        self.wx = param(init.dense(D, (C, D, di), dtype))
        self.wbc = param(init.dense(D, (C, D, 2 * N), dtype))
        self.wdt = param(init.dense(D, (C, D, H), dtype))
        self.conv_x = param(init.dense(Kc, (C, Kc, di), dtype))
        self.conv_bc = param(init.dense(Kc, (C, Kc, 2 * N), dtype))
        self.conv_b_x = param(init.full(0.0, (C, di), dtype))
        self.conv_b_bc = param(init.full(0.0, (C, 2 * N), dtype))
        self.A_log = param(init.full(0.0, (C, H), torch.float32))
        self.dt_bias = param(init.full(0.0, (C, H), torch.float32))
        self.out_norm = param(init.full(1.0, (C, di), torch.float32))
        self.out_proj = param(init.dense(di, (C, di, D), dtype))

    def forward(self, x, cache=None, *, compute_dtype, use_kernels=True,
                layout=PLAIN):
        """x [c, b, s, D].  cache None (the scan over the s positions) or
        `init_ssm_cache`'s dict for one token (s = 1).  `use_kernels`
        false runs B6 and B7's plain versions.  Sharded, the conv and the
        scan run on each shard's heads (split over `model` when the heads
        divide it, else gathered), with B and C, which every head reads,
        gathered over `model`.  Returns (out [c, b, s, D], the next cache
        or None)."""
        cfg, cd, L = self.cfg, compute_dtype, layout
        c, b, s, _ = x.shape
        N, H, P = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        z = L.proj("cbsd,cdi->cbsi", x, self.wz, cd)
        xs = L.proj("cbsd,cdi->cbsi", x, self.wx, cd)
        bc = L.proj("cbsd,cdn->cbsn", x, self.wbc, cd)
        dt = L.proj("cbsd,cdh->cbsh", x, self.wdt, cd)
        dt = F.softplus(dt.float() + self.dt_bias[:, None, None, :])
        A = -torch.exp(self.A_log)                                # [c, H]
        conv_x, conv_bc = L.weight(self.conv_x, cd), L.weight(self.conv_bc, cd)
        b_x, b_bc = L.weight(self.conv_b_x, cd), L.weight(self.conv_b_bc, cd)
        hm = "model" if L.fits(H) else None          # the heads' placement
        ch = L.chain_only(1)[0]
        heads4, whole4 = L.act(4, 3 if hm else None), L.act(4)

        def scan(xs, bc, dt, A, conv_x, conv_bc, b_x, b_bc):
            c, b = xs.shape[:2]
            xs = _causal_conv(xs, conv_x, b_x)
            bc = _causal_conv(bc, conv_bc, b_bc)
            y = ops.ssd(xs.reshape(c, b, s, -1, P), dt, A,
                        bc[..., :N].float(), bc[..., N:].float(),
                        use_kernels=use_kernels)
            return y.reshape(c, b, s, -1).to(cd)

        def step(xs, bc, dt, A, conv_x, conv_bc, b_x, b_bc, cx, cbc, ssm):
            c, b = xs.shape[:2]
            hist_x = torch.cat([cx, xs], dim=2)
            hist_bc = torch.cat([cbc, bc], dim=2)
            xs1 = F.silu(torch.einsum("cbki,cki->cbi", hist_x, conv_x)
                         + b_x[:, None])
            bc1 = F.silu(torch.einsum("cbkn,ckn->cbn", hist_bc, conv_bc)
                         + b_bc[:, None])
            ssm, y1 = ops.ssd_decode_step(
                ssm, xs1.reshape(c, b, -1, P).float(), dt[:, :, 0],
                A, bc1[..., :N].float(), bc1[..., N:].float())
            return (y1.reshape(c, b, 1, -1).to(cd), hist_x[:, :, 1:],
                    hist_bc[:, :, 1:], ssm)

        args = (xs, bc, dt, A, conv_x, conv_bc, b_x, b_bc)
        specs = (heads4, whole4, heads4, (ch, hm), (ch, None, hm),
                 (ch, None, None), (ch, hm), (ch, None))
        new_cache = None
        if cache is None:
            y = L.region(scan, args, specs, heads4)
        else:
            if s != 1:
                raise ValueError(f"the cached path takes one token a step, "
                                 f"got {s}")
            ssm_spec = L.act(5, 2 if hm else None)
            y, cx, cbc, ssm = L.region(
                step, args + (cache["conv_x"], cache["conv_bc"],
                              cache["ssm"]),
                specs + (heads4, whole4, ssm_spec),
                [heads4, heads4, whole4, ssm_spec])
            new_cache = {"conv_x": L.put_like(cx, cache["conv_x"]),
                         "conv_bc": L.put_like(cbc, cache["conv_bc"]),
                         "ssm": L.put_like(ssm, cache["ssm"])}

        # the gated RMSNorm, mamba2's norm(y * silu(z))
        y = rmsnorm(y * F.silu(z.float()).to(cd), self.out_norm,
                    cfg.norm_eps, use_kernels).to(cd)
        return L.proj("cbsi,cid->cbsd", y, self.out_proj, cd), new_cache


def init_ssm_cache(cfg: ModelConfig, n_chains, batch, dtype, device):
    """An `'M'` layer's decode cache: the conv's last K - 1 inputs and
    the float32 SSD state [c, b, H, P, N], all zero."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    K = cfg.conv_kernel
    return {"conv_x": torch.zeros((n_chains, batch, K - 1, di), dtype=dtype,
                                  device=device),
            "conv_bc": torch.zeros((n_chains, batch, K - 1, 2 * N),
                                   dtype=dtype, device=device),
            "ssm": torch.zeros((n_chains, batch, H, P, N),
                               dtype=torch.float32, device=device)}
