"""Kernel B5 on the card: causal GQA attention with an online softmax.

`flash_attention_cuda` launches `csrc/flash_attention.cu`, which replaces
the TPU kernel `_flash_kernel` of the reference
(`repro/kernels/flash_attention.py`); the note at the head of the source
says what bounds it and what each variant's design does about that.
`variant` picks the variant from dtype and shape alone: `decode` for at
most four query rows, `prefill_wgmma` (tensor cores, TMA) for longer bf16
calls with Dh % 8 == 0, and `cuda_cores` (float32 on the CUDA cores, the
kernel the other two replaced) for the rest.  The plain version is
`ref.ref_attention`, whose semantics every variant computes at every
shape (no padding, so no shifted causal diagonal).  `launches` counts
the kernel's launches and nothing else, `variant_launches` the same
launches by variant.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 9 + [_P]
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
# the C launcher's numbering
VARIANTS = ("cuda_cores", "prefill_wgmma", "decode")
# launches by variant (each launch counts here and in `launches`)
variant_launches = dict.fromkeys(VARIANTS, 0)
# the decode variant's query rows a call (Sq)
DECODE_MAX_ROWS = 4
# prefill_wgmma and decode read their operands in 16-byte pieces
ALIGN = 16


def variant(dtype, sq: int, dh: int) -> str:
    """The kernel variant that serves q [.., Sq, Dh] of `dtype`."""
    if sq <= DECODE_MAX_ROWS:
        return "decode"
    if dtype == torch.bfloat16 and dh % 8 == 0:
        return "prefill_wgmma"
    return "cuda_cores"


def flash_attention_cuda(q, k, v, *, causal=True, kv_len=None,
                         kernel_variant=None):
    """q [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh], one dtype of float32 or
    bf16, contiguous, Dh <= 128, Hq % Hkv == 0; kv_len None or int32
    [B].  The decode and prefill_wgmma variants take 16-byte-aligned
    q, k and v.  Logits are scaled by Dh ** -0.5.  `kernel_variant` None
    runs `variant`'s choice; `chip_smoke.py` names "cuda_cores" to time
    the kernel the others replaced on the same inputs.  Returns out
    [B, Hq, Sq, Dh] in q's dtype, on the current stream."""
    global launches
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in DTYPES:
        raise ValueError(f"the attention kernel takes {DTYPES}, got "
                         f"{q.dtype}")
    if not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {Dh}")
    if Hkv < 1 or Hq % Hkv or B > 65535 or Hq > 65535:
        raise ValueError(f"attention: Hq={Hq}, Hkv={Hkv}, B={B}")
    for name, t, shape in (("q", q, (B, Hq, Sq, Dh)),
                           ("k", k, (B, Hkv, Sk, Dh)),
                           ("v", v, (B, Hkv, Sk, Dh))):
        build.check_operand(name, t, q.dtype, shape, dev)
    if kv_len is not None:
        build.check_operand("kv_len", kv_len, torch.int32, (B,), dev)
    kind = chosen = variant(q.dtype, Sq, Dh)
    if kernel_variant is not None:
        if kernel_variant not in (chosen, "cuda_cores"):
            raise ValueError(f"attention: no {kernel_variant} variant for "
                             f"{q.dtype}, Sq={Sq}, Dh={Dh}")
        kind = kernel_variant
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if kind != "cuda_cores" and (ptrs[0] | ptrs[1] | ptrs[2]) % ALIGN:
        raise ValueError(f"q, k, v: not {ALIGN}-byte aligned, as the {kind} "
                         f"variant reads them")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = build.bind("flash_attention", "flash_attention_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(*ptrs, 0 if kv_len is None else kv_len.data_ptr(),
                    out.data_ptr(), B, Hq, Hkv, Sq, Sk, Dh,
                    int(causal), int(q.dtype == torch.bfloat16),
                    VARIANTS.index(kind), build.stream_of(dev))
    build.check_launch("flash_attention", rc)
    launches += 1
    variant_launches[kind] += 1
    return out
