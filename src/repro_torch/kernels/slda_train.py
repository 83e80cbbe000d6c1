"""Kernel B3 on the card: all training sweeps of one fused launch.

`slda_train_sweeps_cuda` launches `csrc/slda_train.cu`, which replaces the
TPU kernel `_train_kernel` of the reference (`repro/kernels/slda_train.py`);
the note at the head of the source says what bounds it and what each
variant's design does about that.  The main path runs the `cluster`
variant: each doc block split across a thread-block cluster (Hopper
only), its documents assigned to (CTA, warp, group) slots by
`slot_plan`; `block` (one CTA per doc block) is the kernel it replaced; `walks` gives
either variant's order of documents.  The plain version is
`ref.slda_train_sweeps_chains`.  `launches` counts the kernel's launches
and nothing else, `variant_launches` the same launches by variant;
`sparse_launches` counts those of them that drew with the sparse
two-stage draw (kernel B4).

`slda_train_stair` is the plan's CPU route over several length buckets
(the reference's `slda_train_stair_jnp`): plain tensor code, no kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref, sparse as _sparse
from .prng import counter_uniform

launches = 0
sparse_launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = ([_P] * 14 + [_I] * 8 + [_F] * 4 + [_I, _I] + [_P] * 3 + [_I, _I, _P]
         + [_I] * 3 + [_P, _P])
# the C launcher's numbering
VARIANTS = ("block", "cluster")
variant_launches = dict.fromkeys(VARIANTS, 0)
# warps a CTA of the cluster variant (up to T = 256; half above, where a
# thread holds 16 topic slots), CTAs a cluster at most (the portable
# limit), topics a half-warp group draws at most
WARPS = 16
MAX_CLUSTER = 8
HALF_WARP_TOPICS = 16
MAX_TOPICS = _sparse.MAX_TOPICS


def cta_warps(T: int) -> int:
    """Warps a CTA of the cluster variant at T topics, as the C launcher
    picks them."""
    return WARPS if T <= 256 else WARPS // 2
_plans: dict = {}          # (D, doc_block, T, device) -> slots


def slot_plan(D: int, doc_block: int, T: int):
    """The cluster variant's assignment of documents to lanes: (cluster,
    slots) with `cluster` the CTAs that share a doc block (at most 8) and
    `slots` int32 [n_blocks, cluster, WARPS, groups, per_slot] the
    documents (indices into the chain's D) each group of lanes walks in
    turn, -1 where none, `warps` = `cta_warps(T)`.  A group is a half-warp
    (two documents a warp) at T <= 16, for the dense and the sparse draw
    alike, else a whole warp.  Each document is
    taken once, by a slot of its own block's cluster; the i-th document
    of a block goes to slot i mod S (S slots a cluster: CTA fastest, then
    warp, then group), so a block short of documents fills every CTA's
    first group before any second one."""
    groups = 2 if T <= HALF_WARP_TOPICS else 1
    warps = cta_warps(T)
    n_blocks = -(-D // doc_block)
    width = min(doc_block, D)                  # the fullest block's docs
    cluster = min(MAX_CLUSTER, -(-width // (warps * groups)))
    n_slots = cluster * warps * groups
    per_slot = -(-width // n_slots)
    slots = torch.full((n_blocks, per_slot, groups, warps, cluster), -1,
                       dtype=torch.int32)
    flat = slots.view(n_blocks, -1)
    for b in range(n_blocks):
        docs = torch.arange(b * doc_block, min(D, (b + 1) * doc_block),
                            dtype=torch.int32)
        flat[b, :docs.numel()] = docs
    # slot i = (entry, group, warp, CTA) with the CTA fastest
    return cluster, slots.permute(0, 4, 3, 2, 1).contiguous()


def walks(D: int, doc_block: int, T: int, variant: str):
    """The documents each group of lanes of `variant` draws in turn, int64
    [walks, per_walk] (-1: none): the cluster variant's slots
    (`slot_plan`), or the block variant's warps (warp w of a block walks
    its documents w, w + warps, ...; 32 warps a CTA up to T = 64, 16 up
    to T = 256, else 8, as the C launcher picks them)."""
    if variant == "cluster":
        _, slots = slot_plan(D, doc_block, T)
        return slots.reshape(-1, slots.shape[-1]).long()
    if variant != "block":
        raise ValueError(f"slda_train: no {variant} variant")
    warps = 32 if T <= 64 else 16 if T <= 256 else 8
    per = -(-min(doc_block, D) // warps)
    out = torch.full((-(-D // doc_block), per, warps), -1)
    for b in range(out.shape[0]):
        docs = torch.arange(b * doc_block, min(D, (b + 1) * doc_block))
        out[b].view(-1)[:docs.numel()] = docs   # d0 + i at (i // w, i % w)
    return out.transpose(1, 2).reshape(-1, per)


def _slots_on(D, doc_block, T, dev):
    key = (D, doc_block, T, dev)
    plan = _plans.get(key)
    if plan is None:
        cluster, slots = slot_plan(D, doc_block, T)
        plan = _plans[key] = (cluster, slots.to(dev))
    return plan


def slda_train_sweeps_cuda(tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t,
                           nt, eta, *, alpha, beta, rho, n_sweeps,
                           doc_block, supervised=True, product_form=False,
                           ctr_stride=None, topic_index=None,
                           kernel_variant="cluster"):
    """tokens int32 / mask f32 / z0 int32 [M, D, N]; seeds int32 [M, D];
    ndt0 f32 [M, D, T]; y, inv_len f32 [M, D]; ntw_t f32 [M, W, T]; nt,
    eta f32 [M, T]; topic_index None (the dense draw) or the sparse
    draw's launch-frozen (idx, vmask, occm) of ntw_t.  `kernel_variant`
    "cluster" (the main path) or "block", the kernel it replaced, which
    `chip_smoke.py` times on the same inputs.  Returns (z_final
    [M, D, N], ndt_final [M, D, T]), on the current stream.  D need not
    be a multiple of `doc_block`: the last block of each chain is short,
    which is the reference's padding with empty documents."""
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
    if not 1 <= T <= MAX_TOPICS:
        raise ValueError(f"the training kernel takes 1 <= T <= "
                         f"{MAX_TOPICS}, got {T}")
    if n_sweeps < 1 or doc_block < 1:
        raise ValueError(f"n_sweeps={n_sweeps}, doc_block={doc_block}")
    if kernel_variant not in VARIANTS:
        raise ValueError(f"slda_train: no {kernel_variant} variant")
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
    plan = (0, 0, 0, 0)
    if kernel_variant == "cluster":
        cluster, slots = _slots_on(D, doc_block, T, dev)
        plan = (slots.data_ptr(), cluster, slots.shape[3], slots.shape[4])
    rec = _sparse.record_scratch(topic_index, M, W, T, dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    launch = build.bind("slda_train", "slda_train_sweeps_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(*(ptr(t) for t in (
            tokens, mask, seeds, z0, ndt0, y, inv_len, ntw_t, nt, eta,
            z_out, ndt_out, z_buf, local)), M, D, N, T, W, int(doc_block),
            int(n_sweeps), int(N if ctr_stride is None else ctr_stride),
            float(alpha), float(beta), float(W * beta), float(rho),
            int(supervised), int(product_form), *index,
            VARIANTS.index(kernel_variant), *plan, ptr(rec),
            build.stream_of(dev))
    build.check_launch("slda_train", rc)
    launches += 1
    variant_launches[kernel_variant] += 1
    sparse_launches += topic_index is not None
    return z_out, ndt_out


def slda_train_stair(seg_tokens, seg_mask, seg_z0, seg_row_start,
                     seg_tok_start, seeds, ndt0, y, inv_len, ntw_t_stack, nt,
                     eta, chain_of_row, *, alpha, beta, rho, vocab_size,
                     ctr_stride, n_sweeps, supervised=True,
                     product_form=False, topic_index=None):
    """The staircase training executor: `n_sweeps` sweeps of every chain
    over a length-bucketed corpus, the rows walked as in
    `slda_predict.slda_predict_stair` (doc-major chain fold, the live row
    suffix a segment) against one stacked [M·W, T] table.

    η and nt are gathered to the rows by `chain_of_row` and frozen for a
    sweep; the log form reads sweep-frozen log(ntw + β) and log(nt + Wβ)
    tables with the own token's two logs fixed up; the running
    Σ_t η_t·N_dt of a row starts each sweep from `ref.lane_eta_dot`, the
    kernels' order.  Between sweeps (not after the last) the table takes
    every row's changed tokens, an exact ±1 scatter, and nt the column sums
    of the rows' ndt deltas by chain: the delayed-count partition is the
    whole corpus (the doc_block → D member of the fused family), where
    the blocks executor refreshes a block's private copy.  At one sweep
    nothing refreshes and every operation is independent per row, so each
    document's result is bit for bit `ref.slda_train_sweeps_chains`'s.
    The sparse draw's index (`topic_index`, [M·W, ·] rows) is the
    launch-entry table's.

    seg_tokens / seg_mask / seg_z0 [R_k, L_k] per segment (token ids
    offset by c·W); seeds int32, y, inv_len f32 [R]; ndt0 [R, T];
    ntw_t_stack [M·W, T]; nt, eta [M, T]; chain_of_row int64 [R].
    Returns (z segments [R_k, L_k], ndt_final [R, T]); the caller
    refreshes the global tables from (z0, z_final)."""
    T = ndt0.shape[-1]
    w_beta = vocab_size * beta
    iota = torch.arange(T, device=ndt0.device)[None, :]
    eta_rows = eta[chain_of_row]
    table = ntw_t_stack.clone() if n_sweeps > 1 else ntw_t_stack
    nt_loc = nt
    segs = [(tok.long(), mk, int(r0), int(n0)) for tok, mk, r0, n0 in
            zip(seg_tokens, seg_mask, seg_row_start, seg_tok_start)]
    z_segs = list(seg_z0)
    ndt = ndt0
    for s in range(n_sweeps):
        nt_rows = nt_loc[chain_of_row]
        ndt_start, ndt = ndt, ndt.clone()
        st = ref.lane_eta_dot(ndt_start, eta_rows)
        if not product_form:
            log_ntw = torch.log(table + beta)
            log_nt_rows = torch.log(nt_rows + w_beta)
        new_z = []
        for (tok, mk, r0, n0), z in zip(segs, z_segs):
            nd, stt, z = ndt[r0:], st[r0:], z.clone()
            sd, y_s, il_s = seeds[r0:], y[r0:], inv_len[r0:]
            eta_s, nt_s = eta_rows[r0:], nt_rows[r0:]
            if not product_form:
                log_nt_s = log_nt_rows[r0:]
            for n in range(tok.shape[1]):
                w, m, z_old = tok[:, n], mk[:, n], z[:, n]
                zo = z_old.long()[:, None]
                old = (iota == zo).to(torch.float32) * m[:, None]
                nd = nd - old
                stt = stt - eta_s.gather(1, zo)[:, 0] * m
                if product_form:
                    prior = (nd + alpha) * (table[w] - old + beta) \
                        / (nt_s - old + w_beta)
                else:
                    # the hoisted logs, the own token's two fixed up
                    own = old > 0
                    fix_ntw = torch.log((table[w, zo[:, 0]] - 1.0) + beta)
                    fix_nt = torch.log((nt_s.gather(1, zo)[:, 0] - 1.0)
                                       + w_beta)
                    prior = (torch.log(nd + alpha)
                             + torch.where(own, fix_ntw[:, None], log_ntw[w])
                             - torch.where(own, fix_nt[:, None], log_nt_s))
                p = ref.token_weights(prior, stt, eta_s, il_s, y_s, rho,
                                      supervised, product_form)
                u = counter_uniform(sd, s * ctr_stride + n0 + n)
                z_new = torch.where(
                    m > 0, ref.draw_rows(p, u, w, m, topic_index), z_old)
                zn = z_new.long()[:, None]
                nd = nd + (iota == zn).to(torch.float32) * m[:, None]
                stt = stt + eta_s.gather(1, zn)[:, 0] * m
                z[:, n] = z_new
            ndt[r0:] = nd
            st[r0:] = stt
            new_z.append(z)
        if s < n_sweeps - 1:        # the whole corpus's delayed counts
            for (tok, mk, _, _), zo, zn in zip(segs, z_segs, new_z):
                changed = mk * (zn != zo).to(mk.dtype)
                table.index_put_((tok, zo.long()), -changed,
                                 accumulate=True)
                table.index_put_((tok, zn.long()), changed, accumulate=True)
            nt_loc = nt_loc + torch.zeros_like(nt_loc).index_add_(
                0, chain_of_row, ndt - ndt_start)
        z_segs = new_z
    return z_segs, ndt
