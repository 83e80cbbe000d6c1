"""The execution plan: the one chain-batched stochastic-EM loop and the one
prediction pass, over a padded corpus.

This is the padded subset of the reference's `ExecutionPlan`: every chain
layout is chain-batched (a single chain is M = 1).  At
`sweeps_per_launch=1` each EM iteration is one `ops.slda_gibbs_sweep`
over all chains followed by the exact count refresh and the η solve; at
`sweeps_per_launch>1` each EM boundary follows one fused
`ops.slda_train_sweeps` launch of that many sweeps (a shorter remainder
launch keeps the total at `n_iters`).  Prediction is one
`ops.slda_predict_sweeps` over a corpus shared by all chains.  The
random numbers come in as arguments (`core.rng`).  `cfg.sampler_mode`
picks the dense or the sparse two-stage draw in all three ops.  The reference's
`jax.lax.scan` over EM boundaries is a Python loop here.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from .regression import solve_eta
from .types import (Corpus, GibbsState, SLDAConfig, SLDAModel,
                    apply_count_deltas, counts_from_assignments)


def build_plan(corpus: Corpus, cfg: SLDAConfig, *,
               chained: bool = False) -> "ExecutionPlan":
    """The plan for `(corpus, cfg)`.  `chained=True` lifts a flat corpus
    [D, N] to one chain [1, D, N] so that the chain-batched EM loop
    applies."""
    if chained and corpus.tokens.dim() == 2:
        corpus = corpus.map(lambda x: x[None])
    return ExecutionPlan(corpus=corpus, cfg=cfg)


@dataclasses.dataclass
class ExecutionPlan:
    """A padded corpus — chain-sharded [M, D, N] for training, flat
    [D, N] (shared by every chain) for prediction — and its config."""

    corpus: Corpus
    cfg: SLDAConfig

    @property
    def n_chains(self):
        return self.corpus.tokens.shape[0] if self.corpus.tokens.dim() == 3 \
            else None

    def sweep_schedule(self) -> tuple:
        """(sweeps_per_launch, n_full_launches, remainder_sweeps); the
        total number of sweeps is always cfg.n_iters."""
        spl = self.cfg.sweeps_per_launch
        if spl <= 1:
            return 1, self.cfg.n_iters, 0
        n_full, rem = divmod(self.cfg.n_iters, spl)
        return spl, n_full, rem

    def train_doc_block(self, n_docs: int) -> int:
        """The fused launch's doc block, clamped to the chain's documents
        rounded up to a multiple of 8.  It is the delayed-count partition,
        so part of the semantics at sweeps_per_launch > 1."""
        return min(self.cfg.train_doc_block, -(-n_docs // 8) * 8)

    def n_boundaries(self) -> int:
        """EM boundaries (count refresh + η solve) of a training run: one
        per sweep at sweeps_per_launch=1, one per launch above — how often
        an `em_hook` sees the state, and how many draws `train_em` takes."""
        _, n_full, rem = self.sweep_schedule()
        return n_full + (1 if rem else 0)

    # ---- the chain-batched EM loop ---------------------------------

    def init_states(self, z_init) -> GibbsState:
        """Counts derived exactly from the initial topics z_init [M, D, N];
        η starts at its prior mean."""
        c, cfg = self.corpus, self.cfg
        ndt, ntw, nt = counts_from_assignments(c.tokens, c.mask, z_init,
                                               cfg.n_topics, cfg.vocab_size)
        eta = torch.full((z_init.shape[0], cfg.n_topics), cfg.mu,
                         dtype=torch.float32, device=z_init.device)
        return GibbsState(z=z_init, ndt=ndt, ntw=ntw, nt=nt, eta=eta)

    def _refresh_and_solve(self, z_new, ndt, state, rebuild_now: bool):
        """THE EM boundary: exact global count refresh — full rebuild or
        incremental (z_old, z_new) deltas, both exact — then the per-chain
        η ridge solve."""
        c, cfg = self.corpus, self.cfg
        if rebuild_now:
            ndt, ntw, nt = counts_from_assignments(
                c.tokens, c.mask, z_new, cfg.n_topics, cfg.vocab_size)
        else:
            ntw, nt = apply_count_deltas(state.ntw, state.nt, c.tokens,
                                         c.mask, state.z, z_new)
        lengths = c.lengths().clamp(min=1.0)
        eta = solve_eta(ndt / lengths[..., None], c.y, cfg)
        return GibbsState(z=z_new, ndt=ndt, ntw=ntw, nt=nt, eta=eta)

    def _seed_sweep(self, state, uniforms, inv_len):
        """One sweep of every chain (one kernel launch on the card)."""
        c, cfg = self.corpus, self.cfg
        return ops.slda_gibbs_sweep(
            c.tokens, c.mask, uniforms, state.z, state.ndt, c.y, inv_len,
            state.ntw, state.nt, state.eta, alpha=cfg.alpha, beta=cfg.beta,
            rho=cfg.rho, supervised=True, sampler_mode=cfg.sampler_mode,
            sparse_topic_cap=cfg.sparse_topic_cap)

    def _blocks_launch(self, state, seeds, inv_len, n_sweeps: int):
        """One fused launch of `n_sweeps` sweeps over every chain, from
        the per-document seeds [M, D] (one kernel-B3 launch on the card)."""
        c, cfg = self.corpus, self.cfg
        return ops.slda_train_sweeps(
            c.tokens, c.mask, state.z, state.ndt, c.y, inv_len, state.ntw,
            state.nt, state.eta, seeds, alpha=cfg.alpha, beta=cfg.beta,
            rho=cfg.rho, n_sweeps=n_sweeps,
            doc_block=self.train_doc_block(c.n_docs), supervised=True,
            product_form=cfg.product_form_sweeps, ctr_stride=c.max_len,
            sampler_mode=cfg.sampler_mode,
            sparse_topic_cap=cfg.sparse_topic_cap)

    def _rebuild_now(self, it: int) -> bool:
        every = self.cfg.count_rebuild_every
        return every > 0 and it % every == 0

    def train_em(self, state0: GibbsState, draws, *, em_hook=None,
                 status0=None):
        """The stochastic-EM loop, `cfg.n_iters` Gibbs sweeps in all.  At
        sweeps_per_launch=1 each iteration is one sweep under its uniforms
        f32 [M, D, N]; above, each EM boundary follows one fused launch
        under its per-document seeds int32 [M, D], with a remainder launch
        of the leftover sweeps.  `draws` yields one tensor per EM boundary
        (`n_boundaries()` of them, `rng.train_draws`).  Each boundary is
        the exact count refresh (a full rebuild every
        `cfg.count_rebuild_every` boundaries, ±1 deltas in between) and
        the η solve.

        `em_hook(state, it, status) -> (state, status)`, when given, is
        called at every EM boundary `it` (the supervisor's attachment
        point); `train_em` then returns `(state, status)`, else `state`."""
        spl, n_full, rem = self.sweep_schedule()
        sizes = [spl] * n_full + ([rem] if rem else [])
        inv_len = 1.0 / self.corpus.lengths().clamp(min=1.0)
        state, status, it = state0, status0, -1
        for it, (n_sweeps, draw) in enumerate(zip(sizes, draws)):
            if spl == 1:
                z_new, ndt = self._seed_sweep(state, draw, inv_len)
            else:
                z_new, ndt = self._blocks_launch(state, draw, inv_len,
                                                 n_sweeps)
            state = self._refresh_and_solve(z_new, ndt, state,
                                            self._rebuild_now(it))
            if em_hook is not None:
                state, status = em_hook(state, it, status)
        if it + 1 != len(sizes):
            raise ValueError(f"{it + 1} draws for {len(sizes)} EM "
                             "boundaries")
        return state if em_hook is None else (state, status)

    def _export(self, state: GibbsState) -> SLDAModel:
        """Per-chain (φ̂, η̂, train MSE/acc) — what crosses the chain
        boundary."""
        from .gibbs import phi_hat
        c, cfg = self.corpus, self.cfg
        zb = state.ndt / c.lengths().clamp(min=1.0)[..., None]
        yhat = (zb @ state.eta[..., None])[..., 0]
        mse = ((yhat - c.y) ** 2).mean(-1)
        acc = ((yhat > 0.5) == (c.y > 0.5)).to(torch.float32).mean(-1)
        return SLDAModel(phi=phi_hat(state, cfg), eta=state.eta,
                         train_mse=mse, train_acc=acc)

    def train(self, z_init, draws):
        """Full chain-batched training from explicit draws (`core.rng`):
        the initial topics and the EM loop's per-boundary draws.
        Returns (GibbsState, SLDAModel), each with leading chain dim."""
        if self.n_chains is None:
            raise ValueError("train wants a chain-sharded corpus "
                             "(build_plan(..., chained=True))")
        state = self.train_em(self.init_states(z_init), draws)
        return state, self._export(state)

    # ---- prediction ------------------------------------------------

    def predict_zbar(self, z0, seeds, models: SLDAModel):
        """Per-chain posterior-mean topic mixtures z̄ [M, D, T] of every
        document of the plan's (shared) corpus, from explicit initial
        topics z0 [M, D, N] and per-document seeds [M, D]."""
        c, cfg = self.corpus, self.cfg
        if self.n_chains is not None:
            raise ValueError("predict wants a shared (flat) corpus")
        M = z0.shape[0]
        ndt0, _, _ = counts_from_assignments(
            c.tokens.expand(M, -1, -1), c.mask.expand(M, -1, -1), z0,
            cfg.n_topics, cfg.vocab_size)
        ndt_avg, _ = ops.slda_predict_sweeps(
            c.tokens, c.mask, z0, ndt0, models.phi, seeds, alpha=cfg.alpha,
            n_burnin=cfg.n_pred_burnin, n_samples=cfg.n_pred_samples,
            ctr_stride=c.max_len, sampler_mode=cfg.sampler_mode,
            sparse_topic_cap=cfg.sparse_topic_cap)
        return ndt_avg / c.lengths().clamp(min=1.0)[:, None]

    def predict(self, z0, seeds, models: SLDAModel):
        """Every chain predicts every document → ŷ [M, D] (Eq. 5)."""
        zb = self.predict_zbar(z0, seeds, models)
        return (zb @ models.eta[..., None])[..., 0]
