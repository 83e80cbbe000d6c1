"""Model configuration of the LM zoo, a copy of the reference's
`ModelConfig` (same fields and defaults, `hd`, `pattern` and
`param_count`, `active_param_count` and the shape properties), kept here
so that the port imports nothing of `repro`.

The per-layer structure is a `layer_pattern` string, one char per layer:
  'A' — attention + (MLP | MoE)   (MoE if n_experts > 0)
  'M' — Mamba-2 mixer block
`shared_attn_every = k` applies one parameter-shared attention+MLP block
after every k-th layer (Zamba2).  An 'A' layer's MLP is a top-k MoE when
`n_experts > 0`; a frontend other than "none" is a stub that projects
precomputed embeddings.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    qkv_bias: bool = False            # qwen2-family
    qk_norm: bool = False             # qwen3-family
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: int = 0                 # per-expert hidden dim
    moe_dense_d_ff: int = 0           # Arctic: dense residual MLP alongside MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight
    # --- SSM / hybrid ---
    layer_pattern: str = ""           # "" → 'A' * n_layers
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    shared_attn_every: int = 0        # Zamba2: shared block cadence (0 = off)
    # --- modality frontend (a stub: precomputed embeddings) ---
    frontend: str = "none"            # "none" | "vision" | "audio"
    n_patches: int = 256              # vision: patches prepended per image
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0           # 0 = full attention
    scan_layers: bool = False         # the reference stacks the layers'
                                      # parameters; the port unstacks them

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> str:
        p = self.layer_pattern or "A" * self.n_layers
        assert len(p) == self.n_layers, (self.name, len(p), self.n_layers)
        return p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:          # Mamba-2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return "A" not in self.pattern and self.shared_attn_every == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the reference's long_500k shape: no attention, a
        Mamba-2 layer, or a sliding window."""
        return self.attention_free or (
            "M" in self.pattern) or self.sliding_window > 0

    def param_count(self) -> int:
        """Exact parameter count of this config (one chain)."""
        D, V, hd = self.d_model, self.vocab_size, self.hd
        n = V * D                                     # embedding
        if not self.tie_embeddings:
            n += V * D                                # lm head
        attn = (D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd
                + self.n_heads * hd * D)
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        if self.qk_norm:
            attn += 2 * hd
        mlp = 3 * D * self.d_ff
        moe = (self.n_experts * 3 * D * self.moe_d_ff
               + D * self.n_experts                   # router
               + 3 * D * self.moe_dense_d_ff)
        di, S = self.d_inner, self.ssm_state
        mamba = (D * (2 * di + 2 * S + self.ssm_heads)   # in_proj
                 + self.conv_kernel * (di + 2 * S)       # depthwise conv
                 + 2 * self.ssm_heads                    # A_log, dt_bias
                 + di                                    # ssd out norm
                 + di * D)                               # out_proj
        for ch in self.pattern:
            n += D                                       # pre-norm
            if ch == "A":
                n += attn + D + (moe if self.is_moe else mlp)
            else:
                n += mamba
        if self.shared_attn_every:
            n += attn + mlp + 2 * D                      # one shared block
        n += D                                           # final norm
        return n

    def active_param_count(self) -> int:
        """Parameters a token reads (MoE: the top-k experts only), the N
        of 6·N·tokens."""
        if not self.is_moe:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff
        act_moe = self.moe_top_k * 3 * self.d_model * self.moe_d_ff
        return self.param_count() - self.pattern.count("A") * (
            full_moe - act_moe)
