"""AdamW with per-chain semantics."""
from .adamw import (OptConfig, adamw_update, clip_by_global_norm_per_chain,
                    global_norm_per_chain, init_opt_state, lr_schedule,
                    quantize_grads)

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "global_norm_per_chain", "clip_by_global_norm_per_chain",
           "quantize_grads"]
