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

# memory plan: too large for per-device replicas → 1 chain per pod,
# FSDP over the data axis, bf16 optimizer state (DESIGN.md §6)
RUN = dict(chains_single=1, chains_multi=2, fsdp=True, accum_steps=16,
           param_dtype="float32", opt_dtype="bfloat16")

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-32b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32)
