"""The counter-hash PRNG of the prediction and fused training samplers,
bit for bit.

`counter_uniform(seed, ctr)` is the murmur3-finalizer mix of the
reference (`repro.kernels.slda_predict.counter_uniform`): uint32
arithmetic, top 24 bits scaled to [0, 1).  torch has no uint32 shift on
the CPU, so the plain version computes in int64 and masks to 32 bits;
the CUDA kernels compute the same function in uint32 (`slda_common.cuh`).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_INV24 = 2.0 ** -24


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for int64 a in [0, 2^32): split a into 16-bit
    halves so no int64 product overflows."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def counter_uniform(seed, ctr) -> torch.Tensor:
    """Counter-based uniform in [0, 1) from int32 (seed, ctr); broadcasts."""
    seed = torch.as_tensor(seed).to(torch.int64) & _M32
    ctr = torch.as_tensor(ctr).to(torch.int64) & _M32
    x = seed ^ _mul32(ctr, _GOLDEN)
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 13), _MIX2)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * _INV24


def predict_uniforms(seeds, n_sweeps: int, n_tokens: int,
                     ctr_stride: int | None = None) -> torch.Tensor:
    """The [D, n_sweeps, N] uniforms the prediction kernel derives on the
    fly, materialized for tests: token n of sweep s of document d draws
    counter_uniform(seeds[d], s·ctr_stride + n) (ctr_stride defaults to N).
    The fused training kernel (B3) uses the same layout, with s the sweep
    index inside the launch (the reference's `train_uniforms`).
    """
    if ctr_stride is None:
        ctr_stride = n_tokens
    seeds = torch.as_tensor(seeds)
    dev = seeds.device
    ctr = (torch.arange(n_sweeps, dtype=torch.int32, device=dev)[:, None]
           * ctr_stride
           + torch.arange(n_tokens, dtype=torch.int32, device=dev)[None, :])
    return counter_uniform(seeds[:, None, None], ctr[None])

