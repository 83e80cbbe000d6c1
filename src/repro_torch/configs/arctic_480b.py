"""arctic-480b [moe] — 128 experts top-2 PLUS a dense residual MLP per
layer (Snowflake Arctic's dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, rope_theta=1e6,
    n_experts=128, moe_top_k=2, moe_d_ff=4864, moe_dense_d_ff=4864,
)

# the reference's run settings: one chain a host group, FSDP and expert
# sharding, bf16 parameters and optimizer state
RUN = dict(chains_single=1, chains_multi=2, fsdp=True, accum_steps=16,
           param_dtype="bfloat16", opt_dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, name="arctic-480b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, n_experts=4, moe_d_ff=256,
    moe_dense_d_ff=256, capacity_factor=8.0)  # no token drops in smoke
