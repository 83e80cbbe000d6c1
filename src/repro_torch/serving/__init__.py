"""Serving of the LM zoo with the paper's combination at the token level."""
from .engine import GenerationConfig, ServingEngine, sample_token

__all__ = ["GenerationConfig", "ServingEngine", "sample_token"]
