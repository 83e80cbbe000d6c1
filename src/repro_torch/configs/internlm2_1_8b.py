"""internlm2-1.8b [dense] — GQA kv=8.  [arXiv:2403.17297; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab_size=92544, rope_theta=1e6,
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=1,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-1.8b-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab_size=512)
