"""Kernel B6 on the card: the Mamba-2 SSD chunked scan.

`ssd_scan_cuda` launches `csrc/ssd_scan.cu`, which replaces the TPU
kernel `_ssd_kernel` of the reference (`repro/kernels/ssd_scan.py`) in
the chain-batched form the models call: x [C, b, s, h, p], A [C, h] (the
reference vmaps its kernel over the chains).  The note at the head of the
source says what bounds it and what each variant's design does about
that.  `variant` picks the variant from dtype and widths alone:
`tensor_cores` (wgmma, float32 operands split into bf16 hi and lo) for
bf16 x with p % 8 == 0 and n % 4 == 0, the served route; `cuda_cores`
(float32 on the CUDA cores, the kernel the other replaced) for float32 x
and other widths.  The plain version is `ref.ref_ssd_chunked`.
`launches` counts the kernel's launches and nothing else,
`variant_launches` the same launches by variant.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 6 + [_I] * 9 + [_P]
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
DTYPES = (torch.float32, torch.bfloat16)
# the C launcher's numbering
VARIANTS = ("cuda_cores", "tensor_cores")
variant_launches = dict.fromkeys(VARIANTS, 0)
# tensor_cores copies x, B and C in 16-byte pieces
ALIGN = 16


def variant(dtype, p: int, n: int) -> str:
    """The kernel variant that scans x [.., p] of `dtype` with state
    width `n`."""
    if dtype == torch.bfloat16 and p % 8 == 0 and n % 4 == 0:
        return "tensor_cores"
    return "cuda_cores"


def ssd_scan_cuda(x, dt, A, B, C, *, chunk=64, kernel_variant=None):
    """x [C, b, s, h, p] float32 or bf16; dt [C, b, s, h], A [C, h], B, C
    [C, b, s, n] float32; contiguous (tensor_cores: x, B and C 16-byte
    aligned); 1 <= chunk <= 64, p <= 64, n <= 128.  `kernel_variant` None
    runs `variant`'s choice; `chip_smoke.py` names "cuda_cores" to time
    the kernel the other replaced on the same inputs.  Returns y
    [C, b, s, h, p] in x's dtype, on the current stream."""
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
    kind = chosen = variant(x.dtype, p, n)
    if kernel_variant is not None:
        if kernel_variant not in (chosen, "cuda_cores"):
            raise ValueError(f"ssd_scan: no {kernel_variant} variant for "
                             f"{x.dtype}, p={p}, n={n}")
        kind = kernel_variant
    if kind == "tensor_cores" and (
            x.data_ptr() | B.data_ptr() | C.data_ptr()) % ALIGN:
        raise ValueError(f"x, B, C: not {ALIGN}-byte aligned, as the "
                         f"{kind} variant reads them")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch = build.bind("ssd_scan", "ssd_scan_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                    C.data_ptr(), out.data_ptr(), Cn, b, s, h, p, n, chunk,
                    int(x.dtype == torch.bfloat16), VARIANTS.index(kind),
                    build.stream_of(dev))
    build.check_launch("ssd_scan", rc)
    launches += 1
    variant_launches[kind] += 1
    return out
