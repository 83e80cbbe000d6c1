"""musicgen-medium [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub (precomputed frame embeddings).
[arXiv:2306.05284; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", n_layers=48, d_model=1536, n_heads=24,
    n_kv_heads=24, d_ff=6144, vocab_size=2048, rope_theta=1e4,
    frontend="audio",
)

RUN = dict(chains_single=16, chains_multi=32, fsdp=False, accum_steps=1,
           param_dtype="float32", opt_dtype="float32")

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-medium-smoke", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab_size=128)
