"""The LM zoo of the port: the dense GQA decoder (`'A'` layers)."""
from .config import ModelConfig
from .transformer import Block, Transformer, check_supported, init_params

__all__ = ["ModelConfig", "Block", "Transformer", "check_supported",
           "init_params"]
