"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA: kv=32, QKV bias).
[hf:Qwen/CodeQwen1.5-7B; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=13440, vocab_size=92416, qkv_bias=True,
    rope_theta=1e6,
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=4,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="codeqwen1.5-7b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=512)
