"""Kernel B6 on the card: the Mamba-2 SSD chunked scan.

`ssd_scan_cuda` launches `csrc/ssd_scan.cu`, which replaces the TPU
kernel `_ssd_kernel` of the reference (`repro/kernels/ssd_scan.py`) in
the chain-batched form the models call: x [C, b, s, h, p], A [C, h] (the
reference vmaps its kernel over the chains).  The note at the head of the
source says what bounds it and what its design does about that.  The
plain version is `ref.ref_ssd_chunked`.  `launches` counts the kernel's
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 6 + [_I] * 8 + [_P]
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan_cuda(x, dt, A, B, C, *, chunk=64):
    """x [C, b, s, h, p] float32 or bf16; dt [C, b, s, h], A [C, h], B, C
    [C, b, s, n] float32; contiguous; 1 <= chunk <= 64, p <= 64,
    n <= 128.  Returns y [C, b, s, h, p] in x's dtype, on the current
    stream."""
    global launches
    Cn, b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if x.dtype not in DTYPES:
        raise ValueError(f"the SSD kernel takes {DTYPES}, got {x.dtype}")
    if not (1 <= chunk <= MAX_CHUNK and p <= MAX_HEAD_DIM
            and n <= MAX_STATE and h <= 65535):
        raise ValueError(f"the SSD kernel takes chunk <= {MAX_CHUNK}, "
                         f"head_dim <= {MAX_HEAD_DIM}, state <= "
                         f"{MAX_STATE}; got chunk={chunk}, h={h}, p={p}, "
                         f"n={n}")
    build.check_operand("x", x, x.dtype, (Cn, b, s, h, p), dev)
    build.check_operand("dt", dt, torch.float32, (Cn, b, s, h), dev)
    build.check_operand("A", A, torch.float32, (Cn, h), dev)
    build.check_operand("B", B, torch.float32, (Cn, b, s, n), dev)
    build.check_operand("C", C, torch.float32, (Cn, b, s, n), dev)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch = build.bind("ssd_scan", "ssd_scan_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), out.data_ptr(), Cn, b, s, h, p, n, chunk,
                    int(x.dtype == torch.bfloat16), build.stream_of(dev))
    build.check_launch("ssd_scan", rc)
    launches += 1
    return out
