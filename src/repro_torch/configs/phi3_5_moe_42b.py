"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=6400, vocab_size=32064, rope_theta=1e6,
    n_experts=16, moe_top_k=2, moe_d_ff=6400,
)

RUN = dict(chains_single=1, chains_multi=2, fsdp=True, accum_steps=8,
           param_dtype="float32", opt_dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, name="phi3.5-moe-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, n_experts=4, moe_d_ff=256,
    capacity_factor=8.0)  # no token drops in smoke
