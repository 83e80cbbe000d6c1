"""The operations the core and the models call, routed by device.

A CUDA tensor goes to the hand-written kernel (`slda_gibbs`,
`slda_train`, `slda_predict`, `flash_attention`, `ssd_scan`, `rmsnorm`),
or the kernel raises; a CPU tensor goes to the plain version in `ref`.
There is no other route and no fallback.  The LM ops (`attention`, `ssd`,
`rmsnorm`) also take the caller's route, `use_kernels` (the reference's
`use_pallas`): false runs the plain version on any device, which is how
the LM trainer runs, under autograd (the kernels have no backward, and
their wrappers refuse an operand that requires a gradient).
The ops are the reference's `chain_axis=True` forms and keep its
layouts: tables come in as `[M, T, W]` and are transposed to the
row-gather `[M, W, T]` layout here, inside the op.  With
`sampler_mode="sparse"` the op also builds the sparse draw's per-word
topic index from that transposed table (`topic_index`: top
`sparse_topic_cap` topics) and hands it to the kernel or the plain
version beside the table, unless the caller hands it in: the plan builds
it once an EM boundary for all of its buckets' launches.
"""
from __future__ import annotations

import torch

from . import flash_attention as _flash
from . import ref, slda_gibbs, slda_predict, slda_train
from . import rmsnorm as _rmsnorm
from . import ssd_scan as _ssd_scan
from .sparse import build_topic_index


def _route(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no sampler kernel for device {t.device}")
    return t.device.type == "cuda"


def _dense(*tensors):
    """The kernels take contiguous operands (a batched solve may return
    strided ones)."""
    return [t.contiguous() for t in tensors]


def topic_index(table, sampler_mode, cap):
    """The sparse draw's index of a table `[M, T, W]` (of its row-gather
    layout `[M, W, T]`), or None for the dense draw."""
    if sampler_mode == "dense":
        return None
    if sampler_mode != "sparse":
        raise ValueError(f"sampler_mode={sampler_mode!r}")
    return tuple(_dense(*build_topic_index(table.transpose(-1, -2), cap)))


def _index_of(table, sampler_mode, cap, given):
    return topic_index(table, sampler_mode, cap) if given is None else given


def slda_gibbs_sweep(tokens, mask, uniforms, z, ndt, y, inv_len, ntw, nt,
                     eta, *, alpha, beta, rho, supervised=True,
                     sampler_mode="dense", sparse_topic_cap=32,
                     topic_index=None):
    """One document-parallel Gibbs sweep for M chains at once.

    tokens/mask/uniforms/z [M, D, N]; ndt [M, D, T]; y/inv_len [M, D];
    ntw [M, T, W]; nt/eta [M, T].  The sparse draw's index is built from
    the sweep-frozen ntw, or handed in.  Returns (z_new, ndt_new)."""
    ntw_t = ntw.transpose(-1, -2)
    kw = dict(alpha=alpha, beta=beta, rho=rho, supervised=supervised,
              topic_index=_index_of(ntw, sampler_mode, sparse_topic_cap,
                                    topic_index))
    if _route(tokens):
        return slda_gibbs.slda_gibbs_sweep_cuda(*_dense(
            tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t, nt, eta), **kw)
    return ref.ref_slda_gibbs_sweep_chains(tokens, mask, uniforms, z, ndt, y,
                                           inv_len, ntw_t, nt, eta, **kw)


def slda_train_sweeps(tokens, mask, z0, ndt0, y, inv_len, ntw, nt, eta,
                      seeds, *, alpha, beta, rho, n_sweeps, doc_block,
                      supervised=True, product_form=False, ctr_stride=None,
                      sampler_mode="dense", sparse_topic_cap=32,
                      topic_index=None):
    """`n_sweeps` training sweeps for M chains in one fused launch, each
    doc block refreshing a private copy of its chain's table between
    sweeps (delayed counts across blocks).  tokens/mask/z0 [M, D, N];
    ndt0 [M, D, T]; y/inv_len [M, D]; ntw [M, T, W]; nt/eta [M, T];
    seeds int32 [M, D].  The sparse draw's index is launch-frozen: built
    once from the entry ntw (or handed in) and shared by every doc block
    of a chain.
    Returns (z_final, ndt_final); the caller refreshes the global tables
    from (z0, z_final)."""
    ntw_t = ntw.transpose(-1, -2)
    kw = dict(alpha=alpha, beta=beta, rho=rho, n_sweeps=n_sweeps,
              doc_block=doc_block, supervised=supervised,
              product_form=product_form, ctr_stride=ctr_stride,
              topic_index=_index_of(ntw, sampler_mode, sparse_topic_cap,
                                    topic_index))
    if _route(tokens):
        return slda_train.slda_train_sweeps_cuda(*_dense(
            tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta), **kw)
    return ref.slda_train_sweeps_chains(tokens, mask, seeds, z0, ndt0, y,
                                        inv_len, ntw_t, nt, eta, **kw)


def slda_predict_sweeps(tokens, mask, z0, ndt0, phi, seeds, *, alpha,
                        n_burnin, n_samples, ctr_stride=None,
                        sampler_mode="dense", sparse_topic_cap=32,
                        topic_index=None):
    """All `n_burnin + n_samples` test-time sweeps for M chains over one
    shared corpus.  tokens/mask [D, N]; z0 [M, D, N]; ndt0 [M, D, T];
    phi [M, T, W]; seeds int32 [M, D].  The sparse draw's index is built
    from each chain's φ̂, or handed in.
    Returns (ndt_avg [M, D, T], z_final [M, D, N])."""
    phi_t = phi.transpose(-1, -2)
    kw = dict(alpha=alpha, n_burnin=n_burnin, n_samples=n_samples,
              ctr_stride=ctr_stride,
              topic_index=_index_of(phi, sampler_mode, sparse_topic_cap,
                                    topic_index))
    if _route(tokens):
        return slda_predict.slda_predict_sweeps_cuda(*_dense(
            tokens, mask, seeds, z0, ndt0, phi_t), **kw)
    return ref.slda_predict_sweeps_chains(tokens, mask, seeds, z0, ndt0,
                                          phi_t, **kw)


def attention(q, k, v, *, causal=True, kv_len=None, use_kernels=True):
    """Causal GQA attention, `ref.ref_attention`'s semantics at every
    shape.  q [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh]; kv_len optional
    [B].  Nothing is padded: the kernel's grid covers the ragged last
    block itself, so the causal diagonal stays at Sk - Sq of the true
    shapes (the reference's padded Pallas route shifts it)."""
    if use_kernels and _route(q):
        if kv_len is not None:
            kv_len = kv_len.to(torch.int32).contiguous()
        return _flash.flash_attention_cuda(*_dense(q, k, v), causal=causal,
                                           kv_len=kv_len)
    return ref.ref_attention(q, k, v, causal=causal, kv_len=kv_len)


def ssd(x, dt, A, B, C, *, chunk=64, use_kernels=True):
    """The Mamba-2 SSD scan over s for every chain at once, the
    reference's `ops.ssd` with the chain axis its models vmap over: x
    [C, b, s, h, p]; dt [C, b, s, h]; A [C, h]; B, C [C, b, s, n] (shared
    by the heads).  Returns y like x.  The chunk is min(chunk, s), as the
    reference takes it; the kernel needs no padding, and equals the
    padded form (a padded step has dt = 0 and carries nothing)."""
    ch = min(chunk, x.shape[2])
    if use_kernels and _route(x):
        return _ssd_scan.ssd_scan_cuda(*_dense(x, dt, A, B, C), chunk=ch)
    return ref.ref_ssd_chunked(x, dt, A, B, C, chunk=ch)


# One token of the SSD recurrence: plain tensor code on every device (the
# reference's `ssd_decode_step`, which warrants no kernel either).
ssd_decode_step = ref.ssd_decode_step


def rmsnorm(x, w, *, eps=1e-6, use_kernels=True):
    """RMSNorm of the rows of x [..., D]: w [D] scales every row, w
    [C, D] the rows of chain c (x [C, ..., D]) by w[c]."""
    D = x.shape[-1]
    C = 1 if w.ndim == 1 else w.shape[0]
    if w.shape[-1] != D or (w.ndim == 2 and (x.ndim < 2 or x.shape[0] != C)):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} with w "
                         f"{tuple(w.shape)}")
    if use_kernels and _route(x):
        # a decode step calls this some hundred times: no operation that
        # would not change the operands
        x3 = x.view(C, -1, D) if x.is_contiguous() else \
            x.reshape(C, -1, D).contiguous()
        if w.dtype != torch.float32:
            w = w.float()
        if w.ndim == 1:
            w = w.view(1, D)
        if not w.is_contiguous():
            w = w.contiguous()
        return _rmsnorm.rmsnorm_cuda(x3, w, eps=eps).view(x.shape)
    return ref.ref_rmsnorm(x, w, eps)
