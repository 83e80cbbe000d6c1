"""qwen3-1.7b [dense] — GQA kv=8 with qk_norm.  [hf:Qwen/Qwen3-1.7B; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=1,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-1.7b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32)
