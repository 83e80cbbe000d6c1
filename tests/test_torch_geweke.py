"""The port's statistical-correctness tier (@slow), after the reference's
`tests/test_statistical.py`.

The parity tests pin the port's plain samplers to the reference draw for
draw; this tier pins them to the model:

  * a Geweke joint-distribution test: the port's fused multi-sweep
    training transition (`ops.slda_train_sweeps` on the CPU, the plain
    version of kernel B3: 2 sweeps a launch, doc_block=1, so that the
    block-local delayed-count refresh runs), composed with exact word
    and label redraws, must leave the joint prior p(z, w, y) invariant,
    so the marginal statistics of successive-conditional chains must
    match independent forward samples of the generative model (Geweke
    2004), in the log and product forms, with the dense and the sparse
    two-stage draw (cap 2 < T = 3, so that stage 2 fires);
  * long-run count invariants: after 50 sweeps of incremental refresh,
    never rebuilt, ndt / ntw / nt equal the counts of z exactly, on the
    seed path (one sweep a launch) and the fused path.

Where the reference runs one chain of 6,000 cycles (burn-in 500, thinned
by 5: 1,100 samples) against 6,000 forward samples, this tier runs
CHAINS successive-conditional chains side by side on the chain axis of
the fused launch, each from a forward sample, BURN cycles of burn-in and
then KEPT samples thinned by THIN: 12,800 samples against 6,000 forward
ones.  The chains are independent, so the Monte Carlo error of the
chains' mean is taken from the spread of the per-chain means (batch
means), which holds whatever the autocorrelation within a chain.  The
cut is the reference's, |z| < 4 on the same seven statistics.  At this
size the tier finds a doubled α (|z| about 20) but not a doubled β, a
quadrupled ρ or an unsupervised sweep (|z| < 4 for each, also at four
times the samples): this tiny model's seven statistics barely move
with them.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (SLDAConfig, counts_from_assignments,
                              init_state, sweep, train_chain)
from repro_torch.data import make_slda_corpus
from repro_torch.kernels import ops

# the reference's tiny joint model: strong priors keep the delayed-count
# bias of the fused sweeps far below the test's resolution
D, N, T, W = 2, 5, 3, 6
ALPHA, BETA, RHO = 0.8, 0.8, 0.5
ETA = np.asarray([1.0, -1.0, 0.5], np.float32)

N_FORWARD = 6000
CHAINS, BURN, KEPT, THIN = 256, 30, 50, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stats(z, w, y):
    """[S, 7] statistics of samples z, w [S, D, N], y [S, D]: first
    moments (topic 0's total, one doc-topic cell, the label mean, one
    topic-word cell), the second moments Σ ndt² and Σ ntw² (which a wrong
    α or β moves while topic symmetry hides it from the means), and
    Σ y·(z̄η), which pins the supervised coupling."""
    s = z.shape[0]
    ndt = (z[..., None] == np.arange(T)).sum(2)              # [S, D, T]
    ntw = np.zeros((s, T, W))
    np.add.at(ntw, (np.arange(s)[:, None], z.reshape(s, -1),
                    w.reshape(s, -1)), 1.0)
    return np.stack([
        (z == 0).sum((1, 2)),
        (z[:, 0] == 0).sum(-1),
        y.mean(-1),
        ((z == 0) & (w == 0)).sum((1, 2)),
        (ndt.astype(np.float64) ** 2).sum((1, 2)),
        (ntw ** 2).sum((1, 2)),
        (y * ((ndt / N) @ ETA)).sum(-1),
    ], axis=-1).astype(np.float64)


def _categorical(rng, p):
    """One draw from each row of p [..., K] (rows summing to 1)."""
    c = np.cumsum(p, -1)
    u = rng.random(p.shape[:-1] + (1,)) * c[..., -1:]
    return np.minimum((c < u).sum(-1), p.shape[-1] - 1)


def _forward(rng, s):
    """s independent draws (z, w, y) of the generative model."""
    theta = rng.dirichlet(np.full(T, ALPHA), (s, D))          # [s, D, T]
    z = _categorical(rng, np.repeat(theta[:, :, None], N, 2))
    phi = rng.dirichlet(np.full(W, BETA), (s, T))             # [s, T, W]
    w = _categorical(rng, phi[np.arange(s)[:, None, None], z])
    zbar = (z[..., None] == np.arange(T)).mean(2)
    y = zbar @ ETA + np.sqrt(RHO) * rng.standard_normal((s, D))
    return z, w, y.astype(np.float32)


def _word_gibbs_sweep(rng, w, z):
    """Exact sequential collapsed Gibbs over the words of every chain:
    w_dn | w_-dn, z ∝ N_{z_dn, w}^{-dn} + β (φ integrated out), which
    leaves p(w | z) invariant."""
    m = w.shape[0]
    wf, zf = w.reshape(m, -1).copy(), z.reshape(m, -1)
    rows = np.arange(m)
    ntw = np.zeros((m, T, W))
    np.add.at(ntw, (rows[:, None], zf, wf), 1.0)
    for i in range(D * N):
        ntw[rows, zf[:, i], wf[:, i]] -= 1.0
        wn = _categorical(rng, (ntw[rows, zf[:, i]] + BETA)
                          / (ntw[rows, zf[:, i]] + BETA).sum(-1,
                                                             keepdims=True))
        ntw[rows, zf[:, i], wn] += 1.0
        wf[:, i] = wn
    return wf.reshape(w.shape)


def _successive(rng, product_form, sampler_mode):
    """CHAINS successive-conditional chains: the port's fused training
    transition on z, an exact word sweep and an exact label redraw a
    cycle; the statistics of the kept cycles, [CHAINS, KEPT, 7]."""
    z, w, y = _forward(rng, CHAINS)
    mask = torch.ones((CHAINS, D, N))
    inv_len = torch.full((CHAINS, D), 1.0 / N)
    eta = torch.from_numpy(ETA)[None].expand(CHAINS, T).contiguous()
    out = []
    for cycle in range(BURN + KEPT * THIN):
        tok, zt = torch.from_numpy(w).int(), torch.from_numpy(z).int()
        ndt, ntw, nt = counts_from_assignments(tok, mask, zt, T, W)
        seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, (CHAINS, D),
                                              dtype=np.int32))
        zt, ndt = ops.slda_train_sweeps(
            tok, mask, zt, ndt, torch.from_numpy(y), inv_len, ntw, nt, eta,
            seeds, alpha=ALPHA, beta=BETA, rho=RHO, n_sweeps=2, doc_block=1,
            product_form=product_form, sampler_mode=sampler_mode,
            sparse_topic_cap=2)
        z = zt.numpy().astype(np.int64)
        w = _word_gibbs_sweep(rng, w, z)
        y = ((ndt.numpy() / N) @ ETA + np.sqrt(RHO)
             * rng.standard_normal((CHAINS, D))).astype(np.float32)
        if cycle >= BURN and (cycle - BURN) % THIN == THIN - 1:
            out.append(_stats(z, w, y))
    return np.stack(out, 1)


@pytest.mark.slow
@pytest.mark.parametrize("sampler_mode", ["dense", "sparse"])
@pytest.mark.parametrize("product_form", [False, True])
def test_geweke_joint_distribution_agreement(product_form, sampler_mode):
    """Successive-conditional against forward marginals within Monte Carlo
    error (|z| < 4 a statistic) for both forms of the fused path and both
    draws (the sparse one at cap 2 < T = 3, stage 2 firing)."""
    fwd = _stats(*_forward(np.random.default_rng(0), N_FORWARD))
    chain = _successive(np.random.default_rng(1), product_form,
                        sampler_mode)
    per_chain = chain.mean(1)                                # [CHAINS, 7]
    se = np.sqrt(fwd.var(0, ddof=1) / fwd.shape[0]
                 + per_chain.var(0, ddof=1) / CHAINS)
    zscores = (fwd.mean(0) - per_chain.mean(0)) / se
    print(f"Geweke z ({product_form=}, {sampler_mode}): {zscores}")
    assert np.all(np.abs(zscores) < 4.0), (
        f"Geweke z-scores {zscores} (stats: nt0, ndt00, ymean, ntw00, "
        f"Σndt², Σntw², Σy·z̄η); forward means {fwd.mean(0)}, chain "
        f"means {per_chain.mean(0)}")


def _assert_counts_of_z(corpus, state, cfg):
    ndt, ntw, nt = counts_from_assignments(corpus.tokens, corpus.mask,
                                           state.z, cfg.n_topics,
                                           cfg.vocab_size)
    for name, want in (("ndt", ndt), ("ntw", ntw), ("nt", nt)):
        assert torch.equal(getattr(state, name), want), name


@pytest.mark.slow
def test_incremental_counts_exact_after_50_sweeps_seed_path():
    """50 sweeps of the seed path (one sweep a launch), each refreshing
    the tables by the exact (z_old, z_new) deltas and never rebuilding
    them: ndt / ntw / nt equal the counts of z exactly."""
    cfg = SLDAConfig(n_topics=12, vocab_size=128, count_rebuild_every=0)
    corpus, _ = make_slda_corpus(20, 32, 128, 12, 24, device="cpu")
    state = init_state(torch.Generator().manual_seed(21), corpus, cfg)
    g = torch.Generator().manual_seed(22)
    for _ in range(50):
        u = torch.rand(tuple(corpus.tokens.shape), generator=g)
        state = sweep(u, corpus, state, cfg, supervised=True,
                      exact_rebuild=False)
    _assert_counts_of_z(corpus, state, cfg)


@pytest.mark.slow
def test_incremental_counts_exact_after_50_sweeps_fused_path():
    """The same 50 sweeps through fused launches of 5 (block-local refresh
    inside a launch, the exact deltas between launches, never rebuilt):
    the tables still equal the counts of z."""
    cfg = SLDAConfig(n_topics=12, vocab_size=128, n_iters=50,
                     sweeps_per_launch=5, count_rebuild_every=0,
                     train_doc_block=8)
    corpus, _ = make_slda_corpus(22, 32, 128, 12, 24, device="cpu")
    state, _ = train_chain(23, corpus, cfg, device="cpu")
    _assert_counts_of_z(corpus, state, cfg)
