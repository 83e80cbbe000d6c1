"""Device resolution for the port's entry points.

An entry point runs on the card unless the caller asks for the CPU: with
no CUDA device present, `resolve_device("cuda")` raises instead of
quietly running on the CPU.
"""
from __future__ import annotations

import torch


def check_full_fp32() -> None:
    """The η solve, `zbar @ eta` and the plain samplers' `p @ triu`
    prefix sums depend on full float32 products: refuse TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "repro_torch needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        check_full_fp32()
    return dev
