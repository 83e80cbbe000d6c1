"""zamba2-2.7b [hybrid] — Mamba2 backbone + ONE parameter-shared attention
block applied every 6 layers.  [arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab_size=32000, rope_theta=1e4,
    layer_pattern="M" * 54, ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6,
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=1,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-2.7b-smoke", n_layers=6, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=512, layer_pattern="M" * 6,
    ssm_state=16, ssm_head_dim=32, shared_attn_every=3)
