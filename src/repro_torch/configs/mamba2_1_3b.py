"""mamba2-1.3b [ssm] — attention-free SSD stack.  [arXiv:2405.21060]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280, layer_pattern="M" * 48, ssm_state=128,
    ssm_head_dim=64, tie_embeddings=True,
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=1,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-1.3b-smoke", n_layers=2, d_model=128, n_heads=1,
    n_kv_heads=1, vocab_size=512, layer_pattern="M" * 2, ssm_state=16,
    ssm_head_dim=32)
