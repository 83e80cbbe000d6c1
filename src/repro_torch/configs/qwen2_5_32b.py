"""qwen2.5-32b [dense] — GQA kv=8, QKV bias.  [hf:Qwen/Qwen2.5-32B; hf]

`scan_layers=True` is the reference's stacked layout (`layers_stacked`,
leaves `[L, C, ...]`); `convert.lm_params_from_numpy` unstacks it."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1e6, scan_layers=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-32b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32)
