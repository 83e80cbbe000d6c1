"""Kernel B7 on the card: RMSNorm with a weight per chain.

`rmsnorm_cuda` launches `csrc/rmsnorm.cu`, which replaces the TPU kernel
`_rmsnorm_kernel` of the reference (`repro/kernels/rmsnorm.py`) in the
chain-batched form the models call: x [C, R, D], w [C, D] (the TPU
kernel's w [D] is C = 1).  The plain version is `ref.ref_rmsnorm`.
`launches` counts the kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 3 + [_I] * 3 + [_F, _I, _P]
DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_cuda(x, w, *, eps=1e-6):
    """x [C, R, D] float32 or bf16, w float32 [C, D], contiguous.
    Returns y [C, R, D] in x's dtype, on the current stream."""
    global launches
    C, R, D = x.shape
    dev = x.device
    if x.dtype not in DTYPES:
        raise ValueError(f"the RMSNorm kernel takes {DTYPES}, got {x.dtype}")
    build.check_operand("x", x, x.dtype, (C, R, D), dev)
    build.check_operand("w", w, torch.float32, (C, D), dev)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch = build.bind("rmsnorm", "rmsnorm_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), C, R, D,
                    float(eps), int(x.dtype == torch.bfloat16),
                    build.stream_of(dev))
    build.check_launch("rmsnorm", rc)
    launches += 1
    return out
