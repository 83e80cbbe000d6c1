"""The input shapes of the dry-run's cells, the reference's
`configs.shapes`.

Every LM arch carries the same four shapes:
  train_4k     seq 4096  × global batch 256  → the train step
  prefill_32k  seq 32768 × global batch 32   → the prefill (forward)
  decode_32k   cache 32768 × global batch 128 → one decode step
  long_500k    cache 524288 × global batch 1 → one decode step;
               sub-quadratic archs only

`input_specs` returns tensors on the `meta` device (shapes and dtypes, no
memory), as the reference returns `ShapeDtypeStruct`s.  Training batches
are split across chains; serving batches are replicated per chain (every
chain predicts every request; the predictions are combined, the paper's
Eq. 6).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg: ModelConfig) -> list[str]:
    """The shape cells this arch runs (long_500k only if sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, n_chains: int,
                compute_dtype=torch.bfloat16) -> dict:
    """Meta tensors of one (arch × shape) cell's batch: tokens (and
    targets) int32 [C, b, s], a decode step's one token, vision's patch
    embeddings at prefill and train, audio's frame embeddings always, in
    `compute_dtype`."""
    C = n_chains

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if shape.kind == "train":
        if shape.global_batch % C:
            raise ValueError(f"{shape.name}: batch {shape.global_batch} "
                             f"does not split over {C} chains")
        b = shape.global_batch // C
        spec = {"tokens": meta((C, b, shape.seq_len), torch.int32),
                "targets": meta((C, b, shape.seq_len), torch.int32)}
    elif shape.kind == "prefill":
        spec = {"tokens": meta((C, shape.global_batch, shape.seq_len),
                               torch.int32)}
    else:
        spec = {"tokens": meta((C, shape.global_batch, 1), torch.int32)}
    t = spec["tokens"].shape
    if cfg.frontend == "vision" and shape.kind != "decode":
        # patch embeddings enter at prefill / train; decode reuses the cache
        spec["embeds"] = meta((C, t[1], cfg.n_patches, cfg.d_model),
                              compute_dtype)
    elif cfg.frontend == "audio":
        spec["embeds"] = meta((C, t[1], t[2], cfg.d_model), compute_dtype)
    return spec
