"""How a run is laid out: `DistConfig`, the reference's fields that the
port reads, with `use_kernels` in place of `use_pallas`.

The reference's sharding rules (the chain / data / model axes of a device
mesh mapped onto every tensor) come to the port with its mesh in a later
slice (ROADMAP queue A, item 15's multi-device half), and with them the
fields only they read: `fsdp`, `param_dtype` and the reference's §Perf
switches that shape its XLA sharding.  On one card every tensor lives
whole on the card, and these fields choose the route, the compute dtype,
the accumulation and the activation checkpointing; the optimizer state's
dtype is `OptConfig.opt_dtype`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DistConfig:
    n_chains: int = 1                    # each step checks its batch
    accum_steps: int = 1
    compute_dtype: str = "bfloat16"
    # False → every kernel's plain version (the trainer's route: the
    # kernels have no backward)
    use_kernels: bool = False
    remat: bool = True
    remat_policy: str = "full"           # "full" | "dots"
    opt_prefill_last_only: bool = False
