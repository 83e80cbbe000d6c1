"""Collapsed Gibbs sampling for sLDA (stochastic EM), single-chain API.

Sampling model (Eq. 1 of the paper): the probability of assigning topic t
to token w_{d,n} is

    p(z=t | ·) ∝ N(y_d; μ_{d,n,t}, ρ) · (N_dt^{-dn}+α)/(N_d^{-dn}+Tα)
                                      · (N_tw^{-dn}+β)/(N_t^{-dn}+Wβ)

The token loop inside a document is sequential; documents are swept in
parallel against a sweep-frozen topic-word table refreshed exactly
afterwards (AD-LDA delayed counts).  Chains never talk to each other.
These functions are one chain (M = 1) of the chain-batched plan.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from . import rng
from .types import (Corpus, GibbsState, SLDAConfig, SLDAModel,
                    apply_count_deltas, counts_from_assignments)


def init_state(generator: torch.Generator, corpus: Corpus,
               cfg: SLDAConfig) -> GibbsState:
    """Uniform-random topic init drawn from `generator` (on the corpus's
    device); counts derived exactly from z."""
    z = torch.randint(0, cfg.n_topics, tuple(corpus.tokens.shape),
                      generator=generator, device=corpus.tokens.device,
                      dtype=torch.int32)
    ndt, ntw, nt = counts_from_assignments(
        corpus.tokens, corpus.mask, z, cfg.n_topics, cfg.vocab_size)
    eta = torch.full((cfg.n_topics,), cfg.mu, dtype=torch.float32,
                     device=z.device)
    return GibbsState(z=z, ndt=ndt, ntw=ntw, nt=nt, eta=eta)


def sweep(uniforms: torch.Tensor, corpus: Corpus, state: GibbsState,
          cfg: SLDAConfig, supervised: bool = True,
          exact_rebuild: bool = True) -> GibbsState:
    """One document-parallel sweep under the given uniforms [D, N], then
    the count refresh: a full rebuild (`exact_rebuild=True`) or the exact
    (z_old, z_new) deltas.  η is left as it is."""
    inv_len = 1.0 / corpus.lengths().clamp(min=1.0)
    z, ndt = ops.slda_gibbs_sweep(
        corpus.tokens[None], corpus.mask[None], uniforms[None],
        state.z[None], state.ndt[None], corpus.y[None], inv_len[None],
        state.ntw[None], state.nt[None], state.eta[None], alpha=cfg.alpha,
        beta=cfg.beta, rho=cfg.rho, supervised=supervised,
        sampler_mode=cfg.sampler_mode, sparse_topic_cap=cfg.sparse_topic_cap)
    z, ndt = z[0], ndt[0]
    if exact_rebuild:
        ndt, ntw, nt = counts_from_assignments(
            corpus.tokens, corpus.mask, z, cfg.n_topics, cfg.vocab_size)
    else:
        ntw, nt = apply_count_deltas(state.ntw, state.nt, corpus.tokens,
                                     corpus.mask, state.z, z)
    return GibbsState(z=z, ndt=ndt, ntw=ntw, nt=nt, eta=state.eta)


def zbar(state: GibbsState, corpus: Corpus) -> torch.Tensor:
    """Empirical topic distribution z̄_d of each document."""
    return state.ndt / corpus.lengths().clamp(min=1.0)[..., None]


def phi_hat(state: GibbsState, cfg: SLDAConfig) -> torch.Tensor:
    """Smoothed topic-word distributions, Eq. (3)."""
    return (state.ntw + cfg.beta) / (state.nt[..., None]
                                     + cfg.vocab_size * cfg.beta)


def train_chain(seed: int, corpus, cfg: SLDAConfig, *,
                device="cuda") -> tuple[GibbsState, SLDAModel]:
    """The full stochastic-EM loop for ONE chain on ONE (sub-)corpus:
    Gibbs sweeps (one per launch, or `cfg.sweeps_per_launch` fused)
    alternating with the η ridge solve (Eq. 2).  The draws come from the
    chain's generator seeded from `seed`.  `corpus` is a `Corpus` or a
    flat `BucketedCorpus` (`plan.build_schedule`), whose sweeps run a
    launch a bucket; the returned z is in the padded layout, original
    order."""
    from .plan import build_plan
    dev = resolve_device(device)
    plan = build_plan(corpus.to(dev), cfg, chained=True)
    gens = rng.chain_generators(seed, 1, dev)
    z_init, draws = rng.train_draws(gens, plan.corpus.n_docs,
                                    plan.corpus.max_len, cfg.n_topics,
                                    cfg.n_iters, cfg.sweeps_per_launch)
    state, model = plan.train(z_init, draws)
    return state.map(lambda a: a[0]), model.map(lambda a: a[0])
