"""Kernel B1 on the card: all prediction sweeps in one launch.

`slda_predict_sweeps_cuda` launches `csrc/slda_predict.cu`, which
replaces the TPU kernel `_predict_kernel` of the reference
(`repro/kernels/slda_predict.py`); the note at the head of the source
says what bounds it and what each variant's design does about that.
`variant` picks the variant: `lane` (a document a lane at T <= 16,
dense or sparse, over `lane_layout`'s transposed corpus) on the main
path, else `warp` (a warp a document), the kernel the lane variant
replaced.
The plain version is `ref.slda_predict_sweeps_chains`.  `launches`
counts the kernel's launches and nothing else, `variant_launches` the
same launches by variant; `sparse_launches` counts those of them that
drew with the sparse two-stage draw (kernel B4).

`slda_predict_stair` is the plan's CPU route over several length
buckets (the reference's `slda_predict_stair_jnp`): plain tensor code,
no kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, ref, sparse as _sparse
from .prng import counter_uniform

launches = 0
sparse_launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = ([_P] * 8 + [_I] * 5 + [_F, _I, _I, _I, _F] + [_P] * 3 + [_I, _I]
         + [_P] * 4)
# the C launcher's numbering
VARIANTS = ("warp", "lane")
variant_launches = dict.fromkeys(VARIANTS, 0)
MAX_TOPICS = _sparse.MAX_TOPICS
# topics a lane holds; positions a document may have on the lane variant
# (4 warps' z, one byte a token, in 227 KB of shared memory; for the
# sparse draw beside 4 warps' [17][32]-float gather stages)
LANE_TOPICS = 16
LANE_MAX_N = 232448 // (4 * 32)
LANE_MAX_N_SPARSE = (232448 - 4 * (LANE_TOPICS + 1) * 32 * 4) // (4 * 32)


def variant(T: int, sparse: bool, N: int) -> str:
    """The variant the main path runs at T topics, N positions a
    document: `lane` at T <= 16 (dense or sparse) where the document's z
    fits shared memory, else `warp`."""
    max_n = LANE_MAX_N_SPARSE if sparse else LANE_MAX_N
    return "lane" if T <= LANE_TOPICS and N <= max_n else "warp"


def lane_layout(tokens, mask):
    """The lane variant's view of the shared corpus tokens / mask [D, N]:
    transposed copies (tokens_t int32 [N, D], mask_t f32 [N, D]).  Lane d
    of every chain walks document d, column d of the copies, so a warp
    reads one position of its 32 documents in one coalesced piece."""
    return tokens.t().contiguous(), mask.t().contiguous()


def slda_predict_sweeps_cuda(tokens, mask, seeds, z0, ndt0, phi_t, *, alpha,
                             n_burnin, n_samples, ctr_stride=None,
                             topic_index=None, kernel_variant=None):
    """tokens int32 / mask f32 [D, N] shared by all chains; seeds int32
    [M, D]; z0 int32 [M, D, N]; ndt0 f32 [M, D, T]; phi_t f32 [M, W, T];
    topic_index None (the dense draw) or the sparse draw's (idx, vmask,
    occm) of phi_t.  `kernel_variant` None (`variant`'s choice, the main
    path) or a name of VARIANTS, which `chip_smoke.py` passes to time the
    replaced kernel on the same inputs.  Returns (ndt_avg [M, D, T],
    z_final [M, D, N]), on the current stream."""
    global launches, sparse_launches
    M, W, T = phi_t.shape
    D, N = tokens.shape
    dev = tokens.device
    for name, t, dtype, shape in (
            ("tokens", tokens, torch.int32, (D, N)),
            ("mask", mask, torch.float32, (D, N)),
            ("seeds", seeds, torch.int32, (M, D)),
            ("z0", z0, torch.int32, (M, D, N)),
            ("ndt0", ndt0, torch.float32, (M, D, T)),
            ("phi_t", phi_t, torch.float32, (M, W, T))):
        build.check_operand(name, t, dtype, shape, dev)
    if not 1 <= T <= MAX_TOPICS:
        raise ValueError(f"the prediction kernel takes 1 <= T <= "
                         f"{MAX_TOPICS}, got {T}")
    index = build.topic_index_operands(topic_index, M, W, T, dev)
    sparse = topic_index is not None
    kind = kernel_variant or variant(T, sparse, N)
    if kind not in VARIANTS:
        raise ValueError(f"slda_predict: no {kind} variant")
    if kind == "lane" and variant(T, sparse, N) != "lane":
        raise ValueError(f"slda_predict: the lane variant draws at "
                         f"T <= {LANE_TOPICS}, N <= {LANE_MAX_N} "
                         f"({LANE_MAX_N_SPARSE} sparse)")
    ndt_avg = torch.empty_like(ndt0)
    z_out = torch.empty_like(z0)
    if M * D == 0:
        return ndt_avg, z_out
    launch = build.bind("slda_predict", "slda_predict_sweeps_launch", _ARGS)
    layout = lane_layout(tokens, mask) if kind == "lane" else ()
    ptrs = [t.data_ptr() for t in layout] or [0, 0]
    rec = _sparse.record_scratch(topic_index, M, W, T, dev)
    with build.on_device(dev):
        rc = launch(tokens.data_ptr(), mask.data_ptr(), seeds.data_ptr(),
                    z0.data_ptr(), ndt0.data_ptr(), phi_t.data_ptr(),
                    ndt_avg.data_ptr(), z_out.data_ptr(), M, D, N, T, W,
                    float(alpha), int(n_burnin), int(n_samples),
                    int(N if ctr_stride is None else ctr_stride),
                    float(np.float32(1.0 / n_samples)), *index,
                    VARIANTS.index(kind), *ptrs,
                    0 if rec is None else rec.data_ptr(),
                    build.stream_of(dev))
    build.check_launch("slda_predict", rc)
    launches += 1
    variant_launches[kind] += 1
    sparse_launches += sparse
    return ndt_avg, z_out


def counter_uniform_cuda(seeds, ctrs):
    """counter_uniform of int32 (seeds, ctrs) [n] on the card — the device
    function the prediction kernel draws with, exposed for its bit test."""
    n = seeds.numel()
    for name, t in (("seeds", seeds), ("ctrs", ctrs)):
        build.check_operand(name, t, torch.int32, (n,), seeds.device)
    out = torch.empty(n, dtype=torch.float32, device=seeds.device)
    launch = build.bind("slda_predict", "slda_counter_uniform_launch",
                        [_P, _P, _P, _I, _P])
    with build.on_device(seeds.device):
        rc = launch(seeds.data_ptr(), ctrs.data_ptr(), out.data_ptr(), n,
                    build.stream_of(seeds.device))
    build.check_launch("slda_predict", rc)
    return out


def slda_predict_stair(seg_tokens, seg_mask, seg_z0, seg_row_start,
                       seg_tok_start, seeds, ndt0, phi_t, *, alpha,
                       n_burnin, n_samples, ctr_stride, topic_index=None):
    """The staircase prediction executor: every sweep of every chain over
    a length-bucketed corpus in one pass, token position by position.

    Documents are sorted by length, ascending, and the chains folded
    doc-major (row r = d·M + c), so the bucket widths w_1 < .. < w_K cut
    the positions into segments [w_{k-1}, w_k) on which the documents
    still alive are the row suffix from `seg_row_start[k]`: a sweep takes
    w_K steps (not the Σ_b w_b of one call a bucket), each on the live
    rows only.  Every operation is independent per row and token n of
    segment k in sweep s draws counter_uniform(seeds[r], s·ctr_stride +
    seg_tok_start[k] + n), so each document's result is bit for bit that
    of `ref.slda_predict_sweeps_chains` on the padded corpus.

    seg_tokens / seg_mask / seg_z0 [R_k, L_k] per segment (token ids
    offset by c·W into the stacked table); seeds int32 [R]; ndt0 f32
    [R, T]; phi_t f32 [M·W, T], the chains' tables stacked; topic_index
    None (the dense draw) or the sparse draw's index of phi_t
    ([M·W, ·] rows).  Returns ndt_avg [R, T]."""
    segs = [(tok.long(), mk, z.clone(), int(r0), int(n0))
            for tok, mk, z, r0, n0 in zip(seg_tokens, seg_mask, seg_z0,
                                          seg_row_start, seg_tok_start)]
    ndt = ndt0.clone()
    acc = torch.zeros_like(ndt0)
    for s in range(n_burnin + n_samples):
        for tok, mk, z, r0, n0 in segs:
            nd, sd = ndt[r0:], seeds[r0:]
            for n in range(tok.shape[1]):
                nd, z[:, n] = ref.predict_step(
                    nd, tok[:, n], mk[:, n], z[:, n],
                    counter_uniform(sd, s * ctr_stride + n0 + n), phi_t,
                    alpha, topic_index)
            ndt[r0:] = nd
        if s >= n_burnin:
            acc = acc + ndt
    # explicit f32 reciprocal multiply, as the padded route does
    return acc * float(np.float32(1.0 / n_samples))
