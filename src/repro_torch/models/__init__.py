"""The LM zoo of the port: the GQA decoder (`'A'` layers), Mamba-2
(`'M'` layers) and the hybrid with its shared attention block."""
from .config import ModelConfig
from .transformer import (Block, MambaBlock, Transformer, check_supported,
                          init_params)

__all__ = ["ModelConfig", "Block", "MambaBlock", "Transformer",
           "check_supported", "init_params"]
