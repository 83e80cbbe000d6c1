"""The LM zoo of the port: the GQA decoder (`'A'` layers, dense or MoE),
Mamba-2 (`'M'` layers), the hybrid with its shared attention block and
the stub modality frontends."""
from .config import ModelConfig
from .layers import cross_entropy
from .moe import MoE
from .transformer import (Block, MambaBlock, Transformer, init_params,
                          loss_fn)

__all__ = ["ModelConfig", "Block", "MambaBlock", "MoE", "Transformer",
           "cross_entropy", "init_params", "loss_fn"]
