"""Metrics: step logging and chain-ensemble health."""
from .log import MetricLogger, throughput_tokens_per_s
from .ensemble import chain_divergence, ensemble_health, nanmedian, robust_z

__all__ = ["MetricLogger", "throughput_tokens_per_s", "chain_divergence",
           "ensemble_health", "nanmedian", "robust_z"]
