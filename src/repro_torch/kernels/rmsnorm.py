"""Kernel B7 on the card: RMSNorm with a weight per chain.

`rmsnorm_cuda` launches `csrc/rmsnorm.cu`, which replaces the TPU kernel
`_rmsnorm_kernel` of the reference (`repro/kernels/rmsnorm.py`) in the
chain-batched form the models call: x [C, R, D], w [C, D] (the TPU
kernel's w [D] is C = 1).  `variant` picks the variant from dtype and D:
`rows_in_registers` (each row read once, in 16-byte pieces) where a row
is a whole number of pieces and fits a block's registers, else
`two_pass`.  The plain version is `ref.ref_rmsnorm`.  `launches` counts
the kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 3 + [_I] * 3 + [_F, _I, _I, _P]
DTYPES = (torch.float32, torch.bfloat16)
# the C launcher's numbering
VARIANTS = ("rows_in_registers", "two_pass")
# 16-byte pieces of a row that rows_in_registers holds at most (a block of
# 256 threads, 8 pieces each: D <= 16,384 in bf16, 8,192 in float32)
MAX_PIECES = 2048
ALIGN = 16


def variant(dtype, d: int) -> str:
    """The kernel variant that normalises rows of length `d` of `dtype`."""
    per_piece = ALIGN // (2 if dtype == torch.bfloat16 else 4)
    if d % per_piece == 0 and d // per_piece <= MAX_PIECES:
        return "rows_in_registers"
    return "two_pass"


def rmsnorm_cuda(x, w, *, eps=1e-6, kernel_variant=None):
    """x [C, R, D] float32 or bf16, w float32 [C, D], contiguous (the
    rows_in_registers variant: 16-byte aligned).  `kernel_variant` None
    runs `variant`'s choice; `chip_smoke.py` names "two_pass", the form
    of the kernel the other replaced, to time it on the same inputs.
    Returns y [C, R, D] in x's dtype, on the current stream."""
    global launches
    C, R, D = x.shape
    dev = x.device
    if x.dtype not in DTYPES:
        raise ValueError(f"the RMSNorm kernel takes {DTYPES}, got {x.dtype}")
    build.check_operand("x", x, x.dtype, (C, R, D), dev)
    build.check_operand("w", w, torch.float32, (C, D), dev)
    kind = chosen = variant(x.dtype, D)
    if kernel_variant is not None:
        if kernel_variant not in (chosen, "two_pass"):
            raise ValueError(f"rmsnorm: no {kernel_variant} variant for "
                             f"{x.dtype}, D={D}")
        kind = kernel_variant
    xp, wp = x.data_ptr(), w.data_ptr()
    if kind == "rows_in_registers" and (xp | wp) % ALIGN:
        raise ValueError(f"rmsnorm: x and w must be {ALIGN}-byte aligned "
                         f"for the {kind} variant")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch = build.bind("rmsnorm", "rmsnorm_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(xp, wp, out.data_ptr(), C, R, D,
                    float(eps), int(x.dtype == torch.bfloat16),
                    VARIANTS.index(kind), build.stream_of(dev))
    build.check_launch("rmsnorm", rc)
    launches += 1
    return out
