"""The plain reference of one sLDA fit: M chains trained by stochastic EM
with fused launches of delayed-count Gibbs sweeps, each chain predicting
a shared corpus, and the predictions combined (Simple or Weighted
Average, Eq. 7-9 of the paper).

It is tensor code only, and imports neither JAX nor the program.  It
works out again everything a fit derives from the corpus and the fit's
seed: the per-chain generators and their draws, the shards, the length
buckets and doc blocks of the fused launches, the counter-hash uniforms,
every sweep, the count refreshes, the η solves, the export and the
combine.  The arithmetic is the plain samplers' of `repro_torch` at
commit 025a0b2 (`kernels/ref.py`, `kernels/prng.py`, `mathutil.py`,
`core/{rng,types,regression,plan,combine,parallel}.py`), frozen here
with each operation in the same order, so that a fit of the program and
this one under the same seed draw the same topics: one draw that parts
shows as a gap far above rounding.

`precision` is "float32", the program's as its configuration states it
(TF32 off), or one of the two controls, which have to come out as not
correct: "tf32", the float32 matrix products with their operands rounded
to TF32's 10-bit mantissa as the tensor cores read them with TF32 on, or
"bfloat16", the samplers' weights and draws in bfloat16 (the counts stay
exact float32).

Shapes: a corpus is (tokens int32 [D, N], mask float32 [D, N], y float32
[D]); `settings` is a dict with the keys of `SETTINGS`.
"""
from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2 ** 31 - 1
TRAIN, PREDICT = 0, 1               # the generator streams of a fit

SETTINGS = ("chains", "n_topics", "vocab_size", "alpha", "beta", "rho",
            "mu", "sigma", "label_type", "n_iters", "n_pred_burnin",
            "n_pred_samples", "algorithm", "sweeps_per_launch",
            "train_doc_block", "length_buckets", "bucket_token_block",
            "bucket_overhead_docs")

_M32 = 0xFFFFFFFF
PRECISIONS = ("float32", "tf32", "bfloat16")


def _weights(precision: str):
    """The cast of the samplers' weights and draws."""
    if precision == "bfloat16":
        return lambda t: t.to(torch.bfloat16)
    return lambda t: t


def tf32_round(x):
    """float32 `x` rounded to TF32 (10-bit mantissa; to nearest, ties away
    from zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision: str):
    """a @ b, with TF32 operands under the "tf32" control."""
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


# ------------------------------------------------------------ the draws

def generator(device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from the integers `words`."""
    state = np.random.SeedSequence(list(words)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def chain_generators(seed: int, m: int, device, stream: int) -> list:
    return [generator(device, seed, stream, c) for c in range(m)]


def _mul32(a, c: int):
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def counter_uniform(seed, ctr) -> torch.Tensor:
    """The murmur3-finalizer counter hash of int (seed, ctr), top 24 bits
    scaled to [0, 1); broadcasts."""
    seed = torch.as_tensor(seed).to(torch.int64) & _M32
    ctr = torch.as_tensor(ctr).to(torch.int64) & _M32
    x = seed ^ _mul32(ctr, 0x9E3779B9)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * 2.0 ** -24


def sweep_uniforms(seeds, sweep: int, n_tokens: int, stride: int):
    """[R, N] uniforms of one sweep: token n of row r draws
    counter_uniform(seeds[r], sweep·stride + n)."""
    ctr = sweep * stride + torch.arange(n_tokens, device=seeds.device)
    return counter_uniform(seeds[:, None], ctr[None, :])


# ------------------------------------------------------ the draw itself

def prefix_sum(p):
    """Inclusive prefix sum along the last axis, left to right."""
    cols = list(p.unbind(-1))
    for t in range(1, len(cols)):
        cols[t] = cols[t - 1] + cols[t]
    return torch.stack(cols, -1)


def draw(p, u):
    """Inverse-CDF categorical draw z = #{t : c_t < u·c_{T-1}}, clamped."""
    c = prefix_sum(p)
    z = (c < (u * c[:, -1])[:, None]).sum(-1)
    return z.clamp(max=p.shape[-1] - 1).to(torch.int32)


def lane_eta_dot(ndt, eta_rows):
    """Σ_t η_t·N_dt of each row, in groups of G lanes (G = 16 at T <= 16,
    else 32): lane sums left to right, then a butterfly."""
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


# ------------------------------------------------------------ the counts

def counts(tokens, mask, z, n_topics: int, vocab_size: int):
    """Exact (ndt [.., D, T], ntw [.., T, W], nt [.., T]) of topics z
    [.., D, N]; leading dims are chains."""
    lead, (D, N) = tokens.shape[:-2], tokens.shape[-2:]
    B = int(np.prod(lead)) if lead else 1
    dev = tokens.device
    b = torch.arange(B, device=dev)[:, None, None].expand(B, D, N)
    d = torch.arange(D, device=dev)[None, :, None].expand(B, D, N)
    zz = z.reshape(B, D, N).long()
    m = mask.reshape(B, D, N)
    ndt = torch.zeros((B, D, n_topics), dtype=torch.float32, device=dev)
    ndt.index_put_((b, d, zz), m, accumulate=True)
    ntw = torch.zeros((B, n_topics, vocab_size), dtype=torch.float32,
                      device=dev)
    ntw.index_put_((b, zz, tokens.reshape(B, D, N).long()), m,
                   accumulate=True)
    ndt = ndt.reshape(lead + (D, n_topics))
    ntw = ntw.reshape(lead + (n_topics, vocab_size))
    return ndt, ntw, ntw.sum(-1)


# ------------------------------------------------ buckets and doc blocks

def _dp_cuts(segs, max_buckets: int, overhead: float) -> list:
    """The contiguous grouping of width runs [(count, width)] into at most
    max_buckets buckets of least Σ_b (D_b + overhead)·N_b; the segment end
    index of each bucket."""
    S = len(segs)
    max_b = max(1, min(max_buckets, S))
    pref = [0]
    for c, _ in segs:
        pref.append(pref[-1] + c)
    inf = float("inf")
    dp = [[inf] * (S + 1) for _ in range(max_b + 1)]
    cut = [[0] * (S + 1) for _ in range(max_b + 1)]
    dp[0][0] = 0.0
    for b in range(1, max_b + 1):
        for j in range(1, S + 1):
            w = segs[j - 1][1]
            for i in range(j):
                if dp[b - 1][i] == inf:
                    continue
                c = dp[b - 1][i] + (pref[j] - pref[i] + overhead) * w
                if c < dp[b][j]:
                    dp[b][j] = c
                    cut[b][j] = i
    best = min(range(1, max_b + 1), key=lambda b: dp[b][S])
    bounds, j = [], S
    for b in range(best, 0, -1):
        bounds.append(j)
        j = cut[b][j]
    return list(reversed(bounds))


def schedule(lengths: np.ndarray, n_buckets: int, token_block: int,
             overhead: float, max_len: int):
    """The documents' order and the bucket sizes of a schedule: lengths
    int [M, D] (or [D]).  Returns (order [M, D] or [D]: sorted position →
    document, counts, widths).  No buckets (n_buckets 0) is the padded
    corpus: the identity order, one bucket of every document."""
    D = lengths.shape[-1]
    if n_buckets <= 0:
        order = np.broadcast_to(np.arange(D), lengths.shape).copy()
        return order, [D], [max_len]
    order = np.argsort(lengths, axis=-1, kind="stable")
    srt = np.take_along_axis(lengths, order, axis=-1)
    colmax = srt.max(axis=0) if srt.ndim == 2 else srt
    round_w = np.minimum(max_len, np.maximum(
        token_block, -(-colmax // token_block) * token_block))
    segs = []
    for w in round_w.tolist():
        if segs and segs[-1][1] == w:
            segs[-1][0] += 1
        else:
            segs.append([1, w])
    ends = _dp_cuts([tuple(s) for s in segs], max(1, min(n_buckets, D)),
                    float(overhead))
    cnts, widths, o = [], [], 0
    for e in ends:
        cnts.append(sum(c for c, _ in segs[o:e]))
        widths.append(segs[e - 1][1])
        o = e
    return order, cnts, widths


def doc_blocks(cnts, doc_block: int):
    """The fused launch's doc block of each sorted position [D] and the
    number of blocks: each bucket's documents cut into blocks of
    min(doc_block, its count rounded up to 8)."""
    blk, n = [], 0
    for c in cnts:
        size = min(doc_block, -(-c // 8) * 8)
        blk.append(n + np.arange(c) // size)
        n += -(-c // size)
    return np.concatenate(blk), n


# ---------------------------------------------------------- the sweeps

def _gibbs_rows(tok_f, mask_f, unif, z, ndt, y, il, table, nt_rows,
                eta_rows, s_: dict, precision: str):
    """One supervised sweep (product form, dense draw) over R rows in
    lockstep against a sweep-frozen table."""
    R, N = tok_f.shape
    T = ndt.shape[-1]
    lo = _weights(precision)
    iota = torch.arange(T, device=tok_f.device)[None, :]
    s = lane_eta_dot(ndt, eta_rows)
    z_out = torch.empty_like(z)
    alpha, beta, rho = s_["alpha"], s_["beta"], s_["rho"]
    w_beta = s_["vocab_size"] * beta
    for n in range(N):
        w, m, z_old, u = tok_f[:, n], mask_f[:, n], z[:, n], unif[:, n]
        zo = z_old.long()[:, None]
        old = (iota == zo).to(torch.float32) * m[:, None]
        ndt = ndt - old
        s = s - eta_rows.gather(1, zo)[:, 0] * m
        prior = (lo(ndt) + alpha) * (lo(table[w] - old) + beta) \
            / (lo(nt_rows - old) + w_beta)
        mu_t = (lo(s)[:, None] + lo(eta_rows)) * lo(il)[:, None]
        g = -0.5 * (lo(y)[:, None] - mu_t) ** 2 / rho
        p = prior * torch.exp(g - g.max(-1, keepdim=True).values)
        z_new = torch.where(m > 0, draw(p, lo(u)), z_old)
        zn = z_new.long()[:, None]
        ndt = ndt + (iota == zn).to(torch.float32) * m[:, None]
        s = s + eta_rows.gather(1, zn)[:, 0] * m
        z_out[:, n] = z_new
    return z_out, ndt


def train_launch(tokens, mask, z0, ndt0, y, il, ntw, nt, eta, seeds,
                 order, blk, n_blocks: int, n_sweeps: int, s_: dict,
                 precision: str = "float32"):
    """One fused launch of `n_sweeps` sweeps over M chains.  tokens, mask,
    z0 [M, D, N], ndt0 [M, D, T], y, il, seeds [M, D], in original order;
    ntw [M, T, W], nt, eta [M, T] frozen at the launch's start.  Each doc
    block (`blk` of each sorted position, in `order` [M, D]) reads a
    private copy of its chain's table and nt, which its own ±1
    reassignments update between sweeps (not after the last).  Returns
    (z, ndt) in original order."""
    M, D, N = tokens.shape
    W, T = ntw.shape[-1], ntw.shape[-2]
    dev = tokens.device
    order_t = torch.as_tensor(order, device=dev)
    ch = torch.arange(M, device=dev)[:, None]

    def srt(a):
        return a[ch, order_t].reshape((M * D,) + tuple(a.shape[2:]))

    bid = (ch * n_blocks + torch.as_tensor(blk, device=dev)[None, :]
           ).reshape(-1)
    tok_f = srt(tokens).long() + (bid * W)[:, None]
    mask_f, z, ndt = srt(mask), srt(z0), srt(ndt0)
    y_f, il_f, seed_f = srt(y), srt(il), srt(seeds)
    eta_rows = eta[:, None].expand(M, D, T).reshape(M * D, T)
    table = ntw.transpose(-1, -2)[:, None].expand(
        M, n_blocks, W, T).reshape(M * n_blocks * W, T).clone()
    nt_loc = nt[:, None].expand(M, n_blocks, T).reshape(
        M * n_blocks, T).clone()
    for sw in range(n_sweeps):
        u = sweep_uniforms(seed_f, sw, N, N)
        z_new, ndt_new = _gibbs_rows(tok_f, mask_f, u, z, ndt, y_f, il_f,
                                     table, nt_loc[bid], eta_rows, s_,
                                     precision)
        if sw < n_sweeps - 1:
            changed = mask_f * (z_new != z).to(mask_f.dtype)
            table.index_put_((tok_f, z.long()), -changed, accumulate=True)
            table.index_put_((tok_f, z_new.long()), changed,
                             accumulate=True)
            nt_loc.index_add_(0, bid, ndt_new - ndt)
        z, ndt = z_new, ndt_new
    inv = torch.as_tensor(np.argsort(order, axis=-1, kind="stable"),
                          device=dev)
    z = z.reshape(M, D, N)[ch, inv]
    ndt = ndt.reshape(M, D, T)[ch, inv]
    return z, ndt


def predict_avg(tokens, mask, z0, ndt0, phi, seeds, s_: dict,
                precision: str = "float32"):
    """All prediction sweeps of M chains over one shared corpus (tokens,
    mask [D, N]) under frozen φ̂ [M, T, W]: z0 [M, D, N], ndt0 [M, D, T],
    seeds [M, D].  Returns the mean of ndt over the sampling sweeps,
    [M, D, T]."""
    M, D, N = z0.shape
    W, T = phi.shape[-1], phi.shape[-2]
    dev = tokens.device
    lo = _weights(precision)
    off = (torch.arange(M, device=dev) * W)[:, None, None]
    tok_f = (tokens.long()[None] + off).reshape(M * D, N)
    mask_f = mask[None].expand(M, D, N).reshape(M * D, N)
    table = phi.transpose(-1, -2).reshape(M * W, T)
    seeds_f = seeds.reshape(M * D)
    z = z0.reshape(M * D, N).clone()
    ndt = ndt0.reshape(M * D, T)
    acc = torch.zeros_like(ndt)
    iota = torch.arange(T, device=dev)[None, :]
    n_burnin, n_samples = s_["n_pred_burnin"], s_["n_pred_samples"]
    for sw in range(n_burnin + n_samples):
        u_s = sweep_uniforms(seeds_f, sw, N, N)
        for n in range(N):
            w, m, z_old = tok_f[:, n], mask_f[:, n], z[:, n]
            old = (iota == z_old.long()[:, None]).to(torch.float32) \
                * m[:, None]
            ndt = ndt - old
            p = (lo(ndt) + s_["alpha"]) * lo(table[w])
            z_new = torch.where(m > 0, draw(p, lo(u_s[:, n])), z_old)
            ndt = ndt + (iota == z_new.long()[:, None]).to(
                torch.float32) * m[:, None]
            z[:, n] = z_new
        if sw >= n_burnin:
            acc = acc + ndt
    return (acc * float(np.float32(1.0 / n_samples))).reshape(M, D, T)


# ---------------------------------------------- the M-step and the rest

def per_chain(fn, *xs):
    """fn over each chain's slice [c:c+1], concatenated."""
    m = xs[0].shape[0]
    if m == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[c:c + 1] for x in xs)) for c in range(m)])


def per_chain_group(fn, *xs, group: int = 4):
    """fn over groups of exactly `group` chains, the last group filled up
    with copies of its last chain (their results dropped)."""
    outs = []
    for lo in range(0, xs[0].shape[0], group):
        part = [x[lo:lo + group] for x in xs]
        take = part[0].shape[0]
        if take < group:
            part = [torch.cat([p, p[-1:].expand(
                (group - take,) + tuple(p.shape[1:]))]) for p in part]
        outs.append(fn(*part)[:take])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def chain_matvec(a, v, precision: str = "float32"):
    """a [M, R, K] times v [M, K] → [M, R], chain by chain."""
    return per_chain(lambda x, w: _mm(x, w[..., None], precision)[..., 0],
                     a, v)


def solve_eta(zbar, y, s_: dict, precision: str = "float32"):
    """The ridge M-step (Z̄ᵀZ̄/ρ + I/σ) η = Z̄ᵀy/ρ + μ/σ of each chain."""
    def one(zb, yy):
        zt = zb.transpose(-1, -2)
        eye = torch.eye(zb.shape[-1], dtype=zb.dtype, device=zb.device)
        gram = _mm(zt, zb, precision) / s_["rho"] + eye / s_["sigma"]
        rhs = _mm(zt, yy[..., None], precision)[..., 0] / s_["rho"] \
            + s_["mu"] / s_["sigma"]
        return torch.linalg.solve_ex(gram, rhs).result
    return per_chain_group(one, zbar, y)


def _chain_sum(x):
    out = x[0]
    for row in x[1:]:
        out = out + row
    return out


def combine(yhat_te, yhat_tr, train_y, s_: dict):
    """Simple Average (Eq. 7), or Weighted Average with weights ∝ train
    accuracy (binary) or 1 / train MSE (continuous) (Eq. 8-9)."""
    if s_["algorithm"] == "simple":
        a = torch.ones(yhat_te.shape[0], dtype=yhat_te.dtype,
                       device=yhat_te.device)
        return _chain_sum(a[:, None] * yhat_te) / _chain_sum(a).clamp(
            min=1.0)
    if s_["label_type"] == "binary":
        raw = ((yhat_tr > 0.5) == (train_y[None, :] > 0.5)).to(
            torch.float32).mean(-1)
    else:
        mse = ((yhat_tr - train_y[None, :]) ** 2).mean(-1)
        raw = 1.0 / (mse + 1e-12)
    a = torch.ones_like(raw)
    w = torch.where((a > 0) & torch.isfinite(raw), raw,
                    torch.zeros_like(raw))
    w = w / _chain_sum(w).clamp(min=1e-12)
    return _chain_sum(w[:, None] * yhat_te)


# ---------------------------------------------------------------- a fit

def train(seed: int, train_c, s_: dict, precision: str = "float32"
          ) -> dict:
    """The M chains' stochastic EM on the training corpus, split into M
    shards of consecutive documents.  Returns the export of every chain:
    {"phi" [M, T, W], "eta" [M, T], "train_mse" [M], "train_acc" [M]}."""
    tokens, mask, y = train_c
    M, T, W = s_["chains"], s_["n_topics"], s_["vocab_size"]
    D, N = tokens.shape
    dev = tokens.device
    tok, msk, yy = (a.reshape((M, D // M) + tuple(a.shape[1:]))
                    for a in (tokens, mask, y))
    lengths = msk.sum(-1).clamp(min=1.0)
    il = 1.0 / lengths
    gens = chain_generators(seed, M, dev, TRAIN)
    z = torch.stack([torch.randint(0, T, (D // M, N), generator=g,
                                   device=dev, dtype=torch.int32)
                     for g in gens])
    ndt, ntw, nt = counts(tok, msk, z, T, W)
    eta = torch.full((M, T), s_["mu"], dtype=torch.float32, device=dev)
    order, cnts, _ = schedule(
        msk.sum(-1).to("cpu", torch.int64).numpy(), s_["length_buckets"],
        s_["bucket_token_block"], s_["bucket_overhead_docs"], N)
    blk, n_blocks = doc_blocks(cnts, s_["train_doc_block"])
    spl = s_["sweeps_per_launch"]
    n_full, rem = divmod(s_["n_iters"], spl)
    for n_sweeps in [spl] * n_full + ([rem] if rem else []):
        seeds = torch.stack([torch.randint(0, INT32_MAX, (D // M,),
                                           generator=g, device=dev,
                                           dtype=torch.int32)
                             for g in gens])
        z, ndt = train_launch(tok, msk, z, ndt, yy, il, ntw, nt, eta,
                              seeds, order, blk, n_blocks, n_sweeps, s_,
                              precision)
        _, ntw, nt = counts(tok, msk, z, T, W)
        eta = solve_eta(ndt / lengths[..., None], yy, s_, precision)
    yhat = chain_matvec(ndt / lengths[..., None], eta, precision)
    mse = per_chain(lambda a, b: ((a - b) ** 2).mean(-1), yhat, yy)
    acc = ((yhat > 0.5) == (yy > 0.5)).to(torch.float32).mean(-1)
    phi = (ntw + s_["beta"]) / (nt[..., None] + W * s_["beta"])
    return {"phi": phi, "eta": eta, "train_mse": mse, "train_acc": acc}


def predict(seed: int, model: dict, corpus, s_: dict,
            precision: str = "float32"):
    """Every chain's ŷ [M, D] of a shared corpus under its exported φ̂
    and η̂ (Eq. 5)."""
    tokens, mask, _ = corpus
    M, T, W = s_["chains"], s_["n_topics"], s_["vocab_size"]
    D, N = tokens.shape
    dev = tokens.device
    gens = chain_generators(seed, M, dev, PREDICT)
    z0 = torch.stack([torch.randint(0, T, (D, N), generator=g, device=dev,
                                    dtype=torch.int32) for g in gens])
    seeds = torch.stack([torch.randint(0, INT32_MAX, (D,), generator=g,
                                       device=dev, dtype=torch.int32)
                         for g in gens])
    ndt0, _, _ = counts(tokens.expand(M, -1, -1), mask.expand(M, -1, -1),
                        z0, T, W)
    avg = predict_avg(tokens, mask, z0, ndt0, model["phi"], seeds, s_,
                      precision)
    zbar = avg / mask.sum(-1).clamp(min=1.0)[:, None]
    return chain_matvec(zbar, model["eta"], precision)


def _concat(a, b):
    n = max(a[0].shape[-1], b[0].shape[-1])
    pad = lambda x: torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return (torch.cat([pad(a[0]), pad(b[0])]),
            torch.cat([pad(a[1]), pad(b[1])]), torch.cat([a[2], b[2]]))


def fit(seed: int, train_c, test_c, s_: dict, precision: str = "float32"
        ) -> dict:
    """One fit of `s_["algorithm"]` ("simple" or "weighted"): the chains'
    export, every chain's ŷ of the corpus it predicts (the test corpus;
    Weighted Average's test then training corpus, in one pass), and the
    combined ŷ of the test corpus."""
    missing = [k for k in SETTINGS if k not in s_]
    if missing:
        raise ValueError(f"settings lack {missing}")
    if s_["algorithm"] not in ("simple", "weighted"):
        raise ValueError(f"algorithm {s_['algorithm']!r}")
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    model = train(seed, train_c, s_, precision)
    d_te = test_c[0].shape[0]
    if s_["algorithm"] == "weighted":
        yhat_c = predict(seed, model, _concat(test_c, train_c), s_,
                         precision)
        yhat = combine(yhat_c[:, :d_te], yhat_c[:, d_te:], train_c[2], s_)
    else:
        yhat_c = predict(seed, model, test_c, s_, precision)
        yhat = combine(yhat_c, None, None, s_)
    return {**model, "yhat_chains": yhat_c, "yhat": yhat}
