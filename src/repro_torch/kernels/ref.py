"""Plain PyTorch versions of the kernels: the three samplers, attention
(B5), the SSD scan (B6) and RMSNorm (B7).

They are the kernels' semantics written as tensor code: the CPU route of
`kernels.ops`, and what `chip_smoke.py` holds the CUDA kernels against on
the card.  All documents advance in lockstep, one token position at a
time (the dependence along a document is sequential); chains are folded
into the document-row axis around one stacked `[M·W, T]` table with
per-chain token-id offsets `w + c·W` (the fused training sweeps fold
chain × doc block around `[M·B·W, T]`, one private table per block).
The operation order is the reference's (`repro.kernels.ref`), but for two
sums taken here in the kernels' order: the draw's prefix sum (the
reference's `p @ triu(T)`, left to right: `mathutil.prefix_sum`) and the
training sweeps' Σ_t η_t·N_dt (a sum a lane, then a butterfly:
`lane_eta_dot`).

Each takes `topic_index=(idx, vmask, occm)` (`[M, W, cap]`, `[M, W, cap]`,
`[M, W, T]`, `core.types.topic_occupancy_index` of the chain's table) to
draw with the sparse two-stage draw (`kernels.sparse`) in place of the
dense one; the weights p are the same either way.  The index folds with
its table: row w + c·W of the stacked `[M·W, ·]` index is chain c's row
w (and the fused sweeps repeat a chain's launch-frozen index for each of
its doc blocks).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.mathutil import prefix_sum
from .prng import counter_uniform, predict_uniforms
from .sparse import gather_index_rows, two_stage_draw

# Real tokens the plain sparse draw has drawn, and those of them that took
# its stage 2 (the residual): the stage-2 share `chip_smoke.py` reports.
# Tensors after the first sparse draw; the caller resets them to 0.
sparse_tally = {"tokens": 0, "stage2": 0}


def _draw(p, u):
    """Inverse-CDF categorical draw: z = #{t : c_t < u·c_{T-1}}, c the
    prefix sum of p taken left to right (`mathutil.prefix_sum`), clamped
    to T - 1 as the kernels clamp it (the count reaches T only where the
    total is not positive)."""
    c = prefix_sum(p)
    z = (c < (u * c[:, -1])[:, None]).sum(-1)
    return z.clamp(max=p.shape[-1] - 1).to(torch.int32)


def draw_rows(p, u, w, m, index):
    """The dense draw, or with a folded index `(idx, vmask, occm)` rows
    the sparse two-stage draw against the rows of the words w (tallying
    the real tokens, mask m > 0, that took stage 2)."""
    if index is None:
        return _draw(p, u)
    z, stage2 = two_stage_draw(p, u, *gather_index_rows(w, *index))
    real = m > 0
    sparse_tally["tokens"] = sparse_tally["tokens"] + real.sum()
    sparse_tally["stage2"] = sparse_tally["stage2"] + (real & stage2).sum()
    return z


def lane_eta_dot(ndt, eta_rows):
    """Σ_t η_t·N_dt of each row [R, T] in the order of the sampler
    kernels' groups of G lanes (G = 16 at T <= 16, else 32): lane l sums
    its topics l, l + G, l + 2G, .. left to right, then the group adds
    the lanes' sums by a butterfly (lane l with lane l ^ o, o = G/2, ..,
    1), which leaves every lane with the same float.  A sweep's draws
    depend on this sum through every topic's Gaussian term, so the
    plain samplers take it in this order: one torch reduction,
    `(ndt * eta_rows).sum(-1)`, adds in another order on the card and
    parted B3's draws from the kernel's at T = 512 (ROADMAP C5)."""
    R, T = ndt.shape
    G = 16 if T <= 16 else 32
    K = -(-T // G)
    prod = torch.nn.functional.pad(ndt * eta_rows, (0, K * G - T))
    prod = prod.reshape(R, K, G)
    acc = prod[:, 0]
    for k in range(1, K):
        acc = acc + prod[:, k]
    lanes = torch.arange(G, device=ndt.device)
    o = G // 2
    while o:
        acc = acc + acc[:, lanes ^ o]
        o //= 2
    return acc[:, 0]



def _fold_index(topic_index, copies: int = 1):
    """A chain index `[M, W, ·]` folded to the stacked `[M·W, ·]` rows, or
    to `[M·copies·W, ·]` with each chain's rows repeated for each of its
    `copies` doc blocks; None stays None."""
    if topic_index is None:
        return None
    return tuple(a[:, None].expand(a.shape[0], copies, *a.shape[1:])
                 .reshape(-1, a.shape[-1]) for a in topic_index)


def _fold_chains(tokens, table_t):
    """Chain-folded row layout: tokens [M, D, N] (or shared [D, N]) against
    per-chain tables [M, W, T] → token ids [M·D, N] into the stacked
    [M·W, T] table (int64, ready for indexing) and the stacked table."""
    M, W, T = table_t.shape
    off = (torch.arange(M, device=tokens.device) * W)[:, None, None]
    tok = tokens.long()
    if tok.dim() == 2:
        tok = tok[None]
    tok_f = (tok + off).reshape(-1, tokens.shape[-1])
    return tok_f, table_t.reshape(M * W, T)


def token_weights(prior, s, eta_rows, il, y, rho, supervised,
                  product_form):
    """A token's unnormalized topic weights [R, T] from its collapsed
    prior: with `product_form` the product (N_dt + α)(N_tw + β)/(N_t + Wβ)
    times one exp of the Gaussian term, else the exp of the sum of the
    three factors' logs and the Gaussian term; both shifted by their row
    max.  s is the row's running Σ_t η_t·N_dt [R] (the token taken out)."""
    if supervised:
        mu_t = (s[:, None] + eta_rows) * il[:, None]
        if product_form:
            g = -0.5 * (y[:, None] - mu_t) ** 2 / rho
            return prior * torch.exp(g - g.max(-1, keepdim=True).values)
        prior = prior - 0.5 * (y[:, None] - mu_t) ** 2 / rho
    elif product_form:
        return prior
    return torch.exp(prior - prior.max(-1, keepdim=True).values)


def predict_step(ndt, w, m, z_old, u, table_t, alpha, index):
    """One token position of a prediction sweep over R rows in lockstep:
    the token's topic redrawn against the frozen table rows of its words
    w.  Returns (ndt, z_new)."""
    iota = torch.arange(ndt.shape[-1], device=ndt.device)[None, :]
    old = (iota == z_old.long()[:, None]).to(torch.float32) * m[:, None]
    ndt = ndt - old
    p = (ndt + alpha) * table_t[w]
    z_new = torch.where(m > 0, draw_rows(p, u, w, m, index), z_old)
    ndt = ndt + (iota == z_new.long()[:, None]).to(torch.float32) \
        * m[:, None]
    return ndt, z_new


def _gibbs_rows(tok_f, mask_f, unif_f, z_f, ndt_f, y_f, il_f, table_t,
                nt_rows, eta_rows, alpha, beta, rho, vocab_size,
                supervised, product_form=False, index=None):
    """One supervised sweep over R document rows in lockstep against the
    sweep-frozen table (AD-LDA delayed counts); nt/eta are per row [R, T].
    The log form exponentiates the sum of three logs and the Gaussian
    term; the product form (fused multi-sweep launches) multiplies the
    three factors and one exp of the Gaussian term — the same
    categorical distribution.  `index` is the folded topic index of the
    sparse draw, aligned with the table (None: the dense draw)."""
    R, N = tok_f.shape
    T = ndt_f.shape[-1]
    iota = torch.arange(T, device=tok_f.device)[None, :]
    ndt = ndt_f
    s = lane_eta_dot(ndt, eta_rows)         # running Σ_t η_t N_dt
    z_out = torch.empty_like(z_f)
    w_beta = vocab_size * beta
    for n in range(N):
        w, m, z_old, u = tok_f[:, n], mask_f[:, n], z_f[:, n], unif_f[:, n]
        zo = z_old.long()[:, None]
        old = (iota == zo).to(torch.float32) * m[:, None]
        ndt = ndt - old
        s = s - eta_rows.gather(1, zo)[:, 0] * m
        if product_form:
            prior = (ndt + alpha) * (table_t[w] - old + beta) \
                / (nt_rows - old + w_beta)
        else:
            prior = (torch.log(ndt + alpha)
                     + torch.log(table_t[w] - old + beta)
                     - torch.log(nt_rows - old + w_beta))
        p = token_weights(prior, s, eta_rows, il_f, y_f, rho, supervised,
                          product_form)
        z_new = torch.where(m > 0, draw_rows(p, u, w, m, index),
                            z_old)
        zn = z_new.long()[:, None]
        ndt = ndt + (iota == zn).to(torch.float32) * m[:, None]
        s = s + eta_rows.gather(1, zn)[:, 0] * m
        z_out[:, n] = z_new
    return z_out, ndt


def ref_slda_gibbs_sweep_chains(tokens, mask, uniforms, z, ndt, y, inv_len,
                                ntw_t, nt, eta, alpha, beta, rho,
                                supervised: bool = True, *,
                                topic_index=None):
    """Chain-batched document-parallel sLDA Gibbs sweep (plain B2).

    tokens/mask/uniforms/z [M, D, N]; ndt [M, D, T]; y/inv_len [M, D];
    ntw_t [M, W, T] (transposed, row-gather layout); nt/eta [M, T];
    topic_index the sparse draw's index of ntw_t, or None.
    Returns (z_new [M, D, N] int32, ndt_new [M, D, T])."""
    M, D, N = tokens.shape
    W, T = ntw_t.shape[-2:]
    tok_f, table = _fold_chains(tokens, ntw_t)
    rows = lambda a: a[:, None, :].expand(M, D, T).reshape(M * D, T)
    z2, ndt2 = _gibbs_rows(
        tok_f, mask.reshape(M * D, N), uniforms.reshape(M * D, N),
        z.reshape(M * D, N), ndt.reshape(M * D, T), y.reshape(M * D),
        inv_len.reshape(M * D), table, rows(nt), rows(eta),
        alpha, beta, rho, W, supervised, index=_fold_index(topic_index))
    return z2.reshape(M, D, N), ndt2.reshape(M, D, T)


def ref_slda_gibbs_sweep(tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t,
                         nt, eta, alpha, beta, rho, supervised: bool):
    """Single-chain sweep: tokens/mask/uniforms/z [D, N]; ndt [D, T];
    y/inv_len [D]; ntw_t [W, T]; nt/eta [T].  Returns (z_new, ndt_new)."""
    z2, ndt2 = ref_slda_gibbs_sweep_chains(
        *(a[None] for a in (tokens, mask, uniforms, z, ndt, y, inv_len,
                            ntw_t, nt, eta)),
        alpha, beta, rho, supervised)
    return z2[0], ndt2[0]


def _pad_docs(a, pad):
    """`pad` zero documents after the D of a chain-batched [M, D, ...]."""
    return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) \
        if pad else a


def ref_slda_train_sweeps_chains(tokens, mask, uniforms, z0, ndt0, y,
                                 inv_len, ntw_t, nt, eta, alpha, beta, rho,
                                 supervised: bool, doc_block: int, *,
                                 product_form: bool = False,
                                 topic_index=None, blocks=None):
    """Chain-batched fused training with EXPLICIT uniforms (plain B3).

    tokens/mask/z0 [M, D, N]; uniforms [M, D, S, N] (S sweeps); ndt0
    [M, D, T]; y/inv_len [M, D]; ntw_t [M, W, T] (row-gather layout);
    nt/eta [M, T].  Returns (z_final [M, D, N] int32, ndt_final
    [M, D, T]); the caller refreshes the global tables from (z0, z_final).

    D is padded to B·doc_block with empty documents, as the reference
    pads it: the block partition is part of the semantics.  Chain × doc
    block rows fold around one stacked [M·B·W, T] table: row r = c·D + d
    lies in block k = r // doc_block, whose private copy of chain c's
    table sits at rows k·W.  Every sweep reads the block's sweep-frozen
    copy and nt; between sweeps (not after the last) the block's own ±1
    reassignments land on its copy and nt grows by the column sum of its
    ndt deltas.  The sparse draw's `topic_index` is launch-frozen: built
    from the entry ntw_t, shared by every block of the chain, never
    rebuilt from the blocks' private copies.  `blocks` (table [M, B, W, T],
    nt [M, B, T], `block_tables`) starts the blocks from private tables
    other than copies of (ntw_t, nt): a launch's state part way."""
    M, D, S, N = uniforms.shape
    W, T = ntw_t.shape[-2:]
    pad = (-D) % doc_block
    tokens, mask, uniforms, z0, ndt0, y, inv_len = (
        _pad_docs(a, pad) for a in (tokens, mask, uniforms, z0, ndt0, y,
                                    inv_len))
    R = M * (D + pad)
    copies = R // doc_block
    block = torch.arange(R, device=tokens.device) // doc_block
    tok_f = tokens.reshape(R, N).long() + (block * W)[:, None]
    mask_f, u_f = mask.reshape(R, N), uniforms.reshape(R, S, N)
    if blocks is None:
        blocks = (ntw_t[:, None].expand(M, copies // M, W, T),
                  nt[:, None].expand(M, copies // M, T))
    table = blocks[0].reshape(copies * W, T).clone()
    nt_loc = blocks[1].reshape(copies, T)
    eta_rows = eta[:, None].expand(M, D + pad, T).reshape(R, T)
    z, ndt = z0.reshape(R, N), ndt0.reshape(R, T)
    y_f, il_f = y.reshape(R), inv_len.reshape(R)
    index = _fold_index(topic_index, copies // M)
    for s in range(S):
        z_new, ndt_new = _gibbs_rows(
            tok_f, mask_f, u_f[:, s], z, ndt, y_f, il_f, table,
            nt_loc[block], eta_rows, alpha, beta, rho, W, supervised,
            product_form, index)
        if s < S - 1:
            changed = mask_f * (z_new != z).to(mask_f.dtype)
            table.index_put_((tok_f, z.long()), -changed, accumulate=True)
            table.index_put_((tok_f, z_new.long()), changed, accumulate=True)
            nt_loc = nt_loc + (ndt_new - ndt).reshape(
                copies, doc_block, T).sum(1)
        z, ndt = z_new, ndt_new
    return (z.reshape(M, D + pad, N)[:, :D],
            ndt.reshape(M, D + pad, T)[:, :D])


def slda_train_sweeps_chains(tokens, mask, seeds, z0, ndt0, y, inv_len,
                             ntw_t, nt, eta, *, alpha, beta, rho, n_sweeps,
                             doc_block, supervised=True, product_form=False,
                             ctr_stride=None, topic_index=None):
    """Plain B3: the fused training launch under the counter-hash
    uniforms u = counter_uniform(seeds[c, d], s·ctr_stride + n) that the
    kernel derives per token (`prng.predict_uniforms`), fed through
    `ref_slda_train_sweeps_chains`.  Shapes as there, with seeds int32
    [M, D] in place of the uniforms."""
    M, D, N = tokens.shape
    u = predict_uniforms(seeds.reshape(M * D), n_sweeps, N, ctr_stride)
    return ref_slda_train_sweeps_chains(
        tokens, mask, u.reshape(M, D, n_sweeps, N), z0, ndt0, y, inv_len,
        ntw_t, nt, eta, alpha, beta, rho, supervised, doc_block,
        product_form=product_form, topic_index=topic_index)


def block_tables(tokens, mask, z0, z, ntw_t, nt, doc_block: int):
    """The private tables the doc blocks of a fused launch hold once their
    documents have moved from z0 to z: each block's copy of its chain's
    launch-start ntw_t [M, W, T] and nt [M, T] plus the block's own ±1
    reassignments (integers: exact in any order).  tokens / mask / z0 / z
    [M, D, N].  Returns (table [M, B, W, T], nt [M, B, T]), B = ⌈D /
    doc_block⌉."""
    M, D, N = tokens.shape
    W, T = ntw_t.shape[-2:]
    B = -(-D // doc_block)
    dev = tokens.device
    blk = (torch.arange(M, device=dev)[:, None] * B
           + torch.arange(D, device=dev)[None, :] // doc_block)
    blk = blk[..., None].expand(M, D, N)
    changed = mask * (z != z0).to(mask.dtype)
    zo, zn = z0.long(), z.long()
    table = ntw_t[:, None].expand(M, B, W, T).reshape(M * B * W, T).clone()
    rows = blk * W + tokens.long()
    table.index_put_((rows, zo), -changed, accumulate=True)
    table.index_put_((rows, zn), changed, accumulate=True)
    nt_b = nt[:, None].expand(M, B, T).reshape(M * B, T).clone()
    nt_b.index_put_((blk, zo), -changed, accumulate=True)
    nt_b.index_put_((blk, zn), changed, accumulate=True)
    return table.reshape(M, B, W, T), nt_b.reshape(M, B, T)


def slda_train_sweep_from(tokens, mask, seeds, z0, z, ndt, y, inv_len,
                          ntw_t, nt, eta, *, sweep: int, alpha, beta, rho,
                          doc_block, supervised=True, product_form=False,
                          ctr_stride=None, topic_index=None):
    """Sweep `sweep` (from 0) of a fused launch alone, from the state the
    launch holds before it: (z, ndt) the assignments and counts after the
    sweeps before it, the launch's start z0 and tables (ntw_t, nt), and
    the block-local tables they imply (`block_tables`); the uniforms are
    that sweep's, counter_uniform(seeds[c, d], sweep·ctr_stride + n).
    Shapes as `slda_train_sweeps_chains`.  Returns (z_new, ndt_new)."""
    M, D, N = tokens.shape
    stride = N if ctr_stride is None else ctr_stride
    ctr = (sweep * stride
           + torch.arange(N, dtype=torch.int64, device=tokens.device))
    u = counter_uniform(seeds[..., None, None], ctr)
    return ref_slda_train_sweeps_chains(
        tokens, mask, u, z, ndt, y, inv_len, ntw_t, nt, eta, alpha, beta,
        rho, supervised, doc_block, product_form=product_form,
        topic_index=topic_index,
        blocks=block_tables(tokens, mask, z0, z, ntw_t, nt, doc_block))


def _predict_rows(tok_f, mask_f, z0_f, ndt0_f, table_t, alpha, n_burnin,
                  n_samples, uniform, index=None):
    """All prediction sweeps over R rows in lockstep under frozen φ̂;
    `uniform(s, n)` gives the [R] uniforms of token n in sweep s; `index`
    as `_gibbs_rows`'."""
    N = tok_f.shape[1]
    z = z0_f.clone()
    ndt = ndt0_f
    acc = torch.zeros_like(ndt0_f)
    for s in range(n_burnin + n_samples):
        for n in range(N):
            ndt, z[:, n] = predict_step(ndt, tok_f[:, n], mask_f[:, n],
                                        z[:, n], uniform(s, n), table_t,
                                        alpha, index)
        if s >= n_burnin:
            acc = acc + ndt
    # explicit f32 reciprocal multiply, as the reference kernel does
    return acc * float(np.float32(1.0 / n_samples)), z


def _fold_shared(mask, M):
    """A shared [D, N] mask → chain-folded [M·D, N] rows."""
    D, N = mask.shape
    return mask[None].expand(M, D, N).reshape(M * D, N)


def ref_slda_predict_sweeps_chains(tokens, mask, uniforms, z0, ndt0, phi_t,
                                   alpha, n_burnin: int, *,
                                   topic_index=None):
    """Chain-batched prediction with EXPLICIT uniforms.

    tokens/mask [D, N] shared by all chains; uniforms [M, D, S, N]
    (S = burn-in + samples); z0 [M, D, N]; ndt0 [M, D, T]; phi_t [M, W, T];
    topic_index the sparse draw's index of phi_t, or None.
    Returns (ndt_avg [M, D, T], z_final [M, D, N])."""
    M, D, S, N = uniforms.shape
    T = ndt0.shape[-1]
    tok_f, table = _fold_chains(tokens, phi_t)
    u_f = uniforms.reshape(M * D, S, N)
    avg, z = _predict_rows(tok_f, _fold_shared(mask, M),
                           z0.reshape(M * D, N), ndt0.reshape(M * D, T),
                           table, alpha, n_burnin, S - n_burnin,
                           lambda s, n: u_f[:, s, n],
                           _fold_index(topic_index))
    return avg.reshape(M, D, T), z.reshape(M, D, N)


def ref_slda_predict_sweeps(tokens, mask, uniforms, z0, ndt0, phi_t, alpha,
                            n_burnin: int):
    """Single-chain prediction with explicit uniforms [D, S, N]; phi_t
    [W, T].  Returns (ndt_avg [D, T], z_final [D, N])."""
    avg, z = ref_slda_predict_sweeps_chains(
        tokens, mask, uniforms[None], z0[None], ndt0[None], phi_t[None],
        alpha, n_burnin)
    return avg[0], z[0]


def slda_predict_sweeps_chains(tokens, mask, seeds, z0, ndt0, phi_t, *,
                               alpha, n_burnin, n_samples, ctr_stride=None,
                               topic_index=None):
    """Plain B1: chain-batched prediction with the counter-hash uniforms
    u = counter_uniform(seeds[c, d], s·ctr_stride + n) derived per token,
    as the kernel derives them (no [D, S, N] tensor).

    tokens/mask [D, N] shared; seeds int32 [M, D]; z0 [M, D, N]; ndt0
    [M, D, T]; phi_t [M, W, T]; topic_index as
    `ref_slda_predict_sweeps_chains`'.  Returns (ndt_avg [M, D, T],
    z_final)."""
    M = phi_t.shape[0]
    D, N = mask.shape
    T = ndt0.shape[-1]
    stride = N if ctr_stride is None else ctr_stride
    tok_f, table = _fold_chains(tokens, phi_t)
    seeds_f = seeds.reshape(M * D)
    avg, z = _predict_rows(
        tok_f, _fold_shared(mask, M), z0.reshape(M * D, N),
        ndt0.reshape(M * D, T), table, alpha, n_burnin, n_samples,
        lambda s, n: counter_uniform(seeds_f, s * stride + n),
        _fold_index(topic_index))
    return avg.reshape(M, D, T), z.reshape(M, D, N)


# ------------------------------------------------------------ attention

def ref_attention(q, k, v, *, causal=True, kv_len=None):
    """Plain B5, the reference's softmax attention oracle.

    q [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh] with Hq % Hkv == 0 (query
    head h reads KV head h // (Hq / Hkv)); kv_len optional int [B], the
    valid KV prefix of each row (decode against a padded cache).  Causal
    row i sees keys j <= i + Sk - Sq (the queries are the last Sq
    positions).  Masked logits are -inf, so a row with no valid key is
    NaN, as in the oracle.  Logits are scaled by Dh ** -0.5.  Computes in
    float32; returns q's dtype."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        Dh ** -0.5)
    ki = torch.arange(Sk, device=q.device)
    if causal and Sq > 1:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        logits = logits.masked_fill(ki[None, :] > qi, float("-inf"))
    if kv_len is not None:
        valid = ki[None, :] < kv_len.to(q.device)[:, None]         # [B, Sk]
        logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1),
                       v.float())
    return out.to(q.dtype)


def attention_blocked(q, k, v, *, causal=True, kv_len=None, block_q=512,
                      probs_bf16=False):
    """The reference's `attention_blocked_jnp`: attention a block of
    `block_q` queries at a time, each block's logits over the whole key
    length, so that memory stays [block_q, Sk] a head.  Masked logits are
    -1e30, as the reference's (a row with no valid key averages every
    value instead of going NaN).  `probs_bf16` rounds the probabilities
    and the values to bfloat16 for the second product, which accumulates
    in float32 (the reference's `preferred_element_type`).  The last
    block may be short: each query row is independent, so the reference's
    padding changes no row.  q [B, Hq, Sq, Dh]; k, v [B, Hkv, Sk, Dh];
    kv_len optional [B].  Returns q's dtype."""
    B, Hq, Sq, Dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = Dh ** -0.5
    bq = min(block_q, Sq)
    kf = k.float()
    vf = v.to(torch.bfloat16).float() if probs_bf16 else v.float()
    ks = torch.arange(Sk, device=q.device)
    valid = None if kv_len is None else \
        ks[None, :] < kv_len.to(q.device)[:, None]             # [B, Sk]
    outs = []
    for q0 in range(0, Sq, bq):
        n = min(bq, Sq - q0)
        qb = q[:, :, q0:q0 + n].float().reshape(B, Hkv, g, n, Dh)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf) * scale
        mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
        if causal:
            rows = torch.arange(n, device=q.device) + (q0 + Sk - Sq)
            mask = ks[None, :] <= rows[:, None]
        mask = mask[None, None, None]
        if valid is not None:
            mask = mask & valid[:, None, None, None, :]
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
        p = torch.softmax(s, dim=-1)
        if probs_bf16:
            p = p.to(torch.bfloat16).float()
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        outs.append(o.to(q.dtype).reshape(B, Hq, n, Dh))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def attention_triangular(q, k, v, *, block=512,
                         probs_dtype=torch.bfloat16):
    """The reference's `attention_triangular_jnp`: causal attention over
    the lower-triangular (i, j <= i) block pairs with an online softmax,
    about half the blocked form's work.  Probabilities are rounded to
    `probs_dtype` (the reference's default bfloat16) and so is each
    block's product with the values; the softmax statistics stay
    float32.  Square causal calls only (Sq = Sk, no kv_len).  Returns
    q's dtype."""
    B, Hq, S, Dh = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = Dh ** -0.5
    bq = min(block, S)
    q5 = q.reshape(B, Hkv, g, S, Dh)
    tri = torch.ones((bq, bq), dtype=torch.bool, device=q.device).tril()
    outs = []
    for i0 in range(0, S, bq):
        n = min(bq, S - i0)
        qb = q5[:, :, :, i0:i0 + n].float()
        m = torch.full((B, Hkv, g, n, 1), -1e30, device=q.device)
        l = torch.zeros((B, Hkv, g, n, 1), device=q.device)
        acc = torch.zeros((B, Hkv, g, n, Dh), device=q.device)
        for j0 in range(0, i0 + 1, bq):
            nk = min(bq, S - j0)
            kb = k[:, :, j0:j0 + nk].float()
            vb = v[:, :, j0:j0 + nk].to(probs_dtype)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if j0 == i0:
                s = s.masked_fill(~tri[:n, :nk], -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new).to(probs_dtype)
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                            vb).float()
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)).to(q.dtype)
                    .reshape(B, Hq, n, Dh))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


# -------------------------------------------------------------- rmsnorm

def ref_rmsnorm(x, w, eps=1e-6):
    """Plain B7: float32 mean of squares, rsqrt(var + eps), scale by w,
    cast back to x's dtype.  w [D] scales every row; w [C, D] scales the
    rows of chain c (x [C, ..., D]) by w[c], as `models.layers.rmsnorm`
    broadcasts it."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    w = w.float()
    if w.ndim == 2:
        w = w.reshape((w.shape[0],) + (1,) * (x.ndim - 2) + (w.shape[-1],))
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


# -------------------------------------------------------------------- ssd

def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One token of the SSD recurrence for every chain, the models' decode
    route on every device (a few elementwise passes over the state: no
    kernel).  state float32 [C, b, h, p, n]; x_t [C, b, h, p]; dt_t
    [C, b, h]; A [C, h]; B_t, C_t [C, b, n].  Returns (state',
    y_t [C, b, h, p])."""
    decay = torch.exp(A[:, None, :] * dt_t)                      # [C, b, h]
    upd = (dt_t[..., None] * x_t)[..., None] * B_t[:, :, None, None, :]
    state = state * decay[..., None, None] + upd
    return state, torch.einsum("cbhpn,cbn->cbhp", state, C_t)


def ref_ssd(x, dt, A, B, C):
    """The SSD oracle, the reference's sequential scan: the state starts
    at zero for each (chain, batch row, head), then
    h_t = exp(A·dt_t)·h_{t-1} + dt_t·x_t ⊗ B_t and y_t = C_t·h_t.

    x [C, b, s, h, p]; dt [C, b, s, h] (> 0); A [C, h] (< 0); B, C
    [C, b, s, n], shared by the heads.  Computes in float32; returns x's
    dtype."""
    Cn, b, s, h, p = x.shape
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    state = torch.zeros((Cn, b, h, p, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state, y = ssd_decode_step(state, xf[:, :, t], dtf[:, :, t], Af,
                                   Bf[:, :, t], Cf[:, :, t])
        ys.append(y)
    return torch.stack(ys, 2).to(x.dtype)


def ref_ssd_chunked(x, dt, A, B, C, *, chunk=64,
                    compute_dtype=torch.float32):
    """Plain B6: the reference's chunk algebra (`ssd_chunked_jnp`, the
    twin of its Pallas kernel) in float32 (or `compute_dtype`: float64
    gives `chip_smoke.py` a yardstick for the kernel and this version
    alike), s zero-padded to a multiple of `chunk`.  Shapes as `ref_ssd`.  Per chunk of L steps, with cum the
    running sum of A·dt inside it:
      y   = ((C Bᵀ) ∘ M) x + exp(cum) ∘ (C h₀ᵀ),
            M[t, s] = exp(cum_t − cum_s)·dt_s for s ≤ t, else 0;
      h₁  = h₀·exp(cum_L) + (x ∘ w)ᵀ B,  w_s = exp(cum_L − cum_s)·dt_s.
    Above the diagonal the exponent is positive and may overflow: M
    selects 0 there, never multiplies by a mask (inf·0 = NaN)."""
    Cn, b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = (t.to(compute_dtype) for t in (x, dt, B, C))
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                       for t in (dtf, Bf, Cf))
    L = chunk
    nc = (s + pad) // L
    xc = xf.reshape(Cn, b, nc, L, h, p)
    dtc = dtf.reshape(Cn, b, nc, L, h)
    Bc, Cc = (t.reshape(Cn, b, nc, L, n) for t in (Bf, Cf))
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    Af = A.to(compute_dtype)[:, None, None, :]                  # [C,1,1,h]
    state = torch.zeros((Cn, b, h, p, n), dtype=compute_dtype,
                        device=x.device)
    ys = []
    for k in range(nc):
        xk, dk, bk, ck = xc[:, :, k], dtc[:, :, k], Bc[:, :, k], Cc[:, :, k]
        cum = (Af * dk).cumsum(2)                               # [C,b,L,h]
        G = torch.einsum("cbln,cbmn->cblm", ck, bk)
        Mdec = torch.where(tri[:, :, None],
                           (cum[:, :, :, None] - cum[:, :, None]).exp(),
                           0.0)                                 # [C,b,L,L,h]
        M = Mdec * dk[:, :, None]
        y = torch.einsum("cblm,cblmh,cbmhp->cblhp", G, M, xk)
        y = y + cum.exp()[..., None] * torch.einsum(
            "cbln,cbhpn->cblhp", ck, state)
        w = (cum[:, :, -1:] - cum).exp() * dk                   # [C,b,L,h]
        state = state * cum[:, :, -1].exp()[..., None, None] + torch.einsum(
            "cblhp,cblh,cbln->cbhpn", xk, w, bk)
        ys.append(y)
    y = torch.stack(ys, 2).reshape(Cn, b, nc * L, h, p)[:, :, :s]
    return y.to(x.dtype)
