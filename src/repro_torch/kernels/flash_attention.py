"""Kernel B5 on the card: causal GQA attention with an online softmax.

`flash_attention_cuda` launches `csrc/flash_attention.cu`, which replaces
the TPU kernel `_flash_kernel` of the reference
(`repro/kernels/flash_attention.py`); the note at the head of the source
says what bounds it and what its design does about that.  The plain
version is `ref.ref_attention`, whose semantics the kernel computes at
every shape (no padding, so no shifted causal diagonal).  `launches`
counts the kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 5 + [_I] * 8 + [_P]
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_cuda(q, k, v, *, causal=True, kv_len=None):
    """q [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh], one dtype of float32 or
    bf16, contiguous, Dh <= 128, Hq % Hkv == 0; kv_len None or int32
    [B].  Logits are scaled by Dh ** -0.5.  Returns out [B, Hq, Sq, Dh]
    in q's dtype, on the current stream."""
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = build.bind("flash_attention", "flash_attention_launch", _ARGS)
    with torch.cuda.device(dev):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    0 if kv_len is None else kv_len.data_ptr(),
                    out.data_ptr(), B, Hq, Hkv, Sq, Sk, Dh,
                    int(causal), int(q.dtype == torch.bfloat16),
                    build.stream_of(dev))
    build.check_launch("flash_attention", rc)
    launches += 1
    return out
