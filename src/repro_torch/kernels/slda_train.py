"""Kernel B3 on the card: all training sweeps of one fused launch.

`slda_train_sweeps_cuda` launches `csrc/slda_train.cu`, which replaces the
TPU kernel `_train_kernel` of the reference (`repro/kernels/slda_train.py`);
the note at the head of the source says what bounds it and what its
design does about that.  The plain version is
`ref.slda_train_sweeps_chains`.  `launches` counts the kernel's
launches and nothing else; `sparse_launches` counts those of them that
drew with the sparse two-stage draw (kernel B4).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0
sparse_launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P] * 14 + [_I] * 8 + [_F] * 4 + [_I, _I] + [_P] * 3 + [_I, _P]


def slda_train_sweeps_cuda(tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t,
                           nt, eta, *, alpha, beta, rho, n_sweeps,
                           doc_block, supervised=True, product_form=False,
                           ctr_stride=None, topic_index=None):
    """tokens int32 / mask f32 / z0 int32 [M, D, N]; seeds int32 [M, D];
    ndt0 f32 [M, D, T]; y, inv_len f32 [M, D]; ntw_t f32 [M, W, T]; nt,
    eta f32 [M, T]; topic_index None (the dense draw) or the sparse
    draw's launch-frozen (idx, vmask, occm) of ntw_t.  Returns (z_final
    [M, D, N], ndt_final [M, D, T]), on the current stream.  D need not be a multiple of `doc_block`: the
    last block of each chain is short, which is the reference's padding
    with empty documents."""
    global launches, sparse_launches
    M, D, N = tokens.shape
    W, T = ntw_t.shape[-2:]
    dev = tokens.device
    for name, t, dtype, shape in (
            ("tokens", tokens, torch.int32, (M, D, N)),
            ("mask", mask, torch.float32, (M, D, N)),
            ("seeds", seeds, torch.int32, (M, D)),
            ("z0", z0, torch.int32, (M, D, N)),
            ("ndt0", ndt0, torch.float32, (M, D, T)),
            ("y", y, torch.float32, (M, D)),
            ("inv_len", inv_len, torch.float32, (M, D)),
            ("ntw_t", ntw_t, torch.float32, (M, W, T)),
            ("nt", nt, torch.float32, (M, T)),
            ("eta", eta, torch.float32, (M, T))):
        build.check_operand(name, t, dtype, shape, dev)
    if not 1 <= T <= 256:
        raise ValueError(f"the training kernel takes 1 <= T <= 256, got {T}")
    if n_sweeps < 1 or doc_block < 1:
        raise ValueError(f"n_sweeps={n_sweeps}, doc_block={doc_block}")
    index = build.topic_index_operands(topic_index, M, W, T, dev)
    z_out = torch.empty_like(z0)
    ndt_out = torch.empty_like(ndt0)
    if M * D == 0:
        return z_out, ndt_out
    n_blocks = -(-D // doc_block)
    fused = n_sweeps > 1
    # z's other ping-pong buffer and each block's private table copy
    z_buf = torch.empty_like(z0) if fused else None
    local = torch.empty((M, n_blocks, W, T), dtype=torch.float32,
                        device=dev) if fused else None
    ptr = lambda t: 0 if t is None else t.data_ptr()
    launch = build.bind("slda_train", "slda_train_sweeps_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(*(ptr(t) for t in (
            tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta,
            z_out, ndt_out, z_buf, local)), M, D, N, T, W, int(doc_block),
            int(n_sweeps), int(N if ctr_stride is None else ctr_stride),
            float(alpha), float(beta), float(W * beta), float(rho),
            int(supervised), int(product_form), *index,
            build.stream_of(dev))
    build.check_launch("slda_train", rc)
    launches += 1
    sparse_launches += topic_index is not None
    return z_out, ndt_out
