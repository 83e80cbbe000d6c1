"""The execution plan: the one chain-batched stochastic-EM loop and the one
prediction pass, over a length-bucketed schedule.

As in the reference's `ExecutionPlan`, every corpus is canonicalized to
a `BucketedCorpus`: the padded corpus is the degenerate one-bucket
schedule with the identity permutation (`as_bucketed`), which gathers
nothing, and `build_schedule` buckets a corpus by length when
`cfg.length_buckets > 0`.  Every chain layout is chain-batched (a single
chain is M = 1).  The plan picks one of the reference's two executors
(`ExecutionPlan.executor`):

  * "blocks", on the card and for one bucket: one kernel launch a
    bucket, with the PRNG counter stride pinned to the source corpus's
    max_len, so that a bucketed run draws what the padded run draws,
    document by document;
  * "stair", on the CPU over several buckets (the reference's `jnp`
    route there): the staircase executors, which fold the chains
    doc-major around one stacked table and walk the bucket widths as
    segments of one pass over the token positions
    (`slda_train.slda_train_stair`, `slda_predict.slda_predict_stair`).
    Prediction and one-sweep launches draw per document what the blocks
    executor draws; a fused launch refreshes the table from the whole
    corpus between its sweeps, where the blocks executor refreshes a doc
    block's private copy: another member of the fused sampler family,
    the reference's on its CPU route.

At `sweeps_per_launch=1` each EM iteration is one `ops.slda_gibbs_sweep`
a bucket over all chains (on either executor), followed by the exact
count refresh and the η solve on original-order rows; at
`sweeps_per_launch>1` each EM boundary follows one fused launch of that
many sweeps, `ops.slda_train_sweeps` a bucket or one staircase launch
(a shorter remainder launch keeps the total at `n_iters`).  Prediction
is one `ops.slda_predict_sweeps` a bucket, or one staircase pass, over
a corpus shared by all chains.  The random numbers come in as arguments
(`core.rng`), drawn at the source's padded shape.  `cfg.sampler_mode`
picks the dense or the sparse two-stage draw; the sparse draw's index is
built once an EM boundary (and once a prediction) for every bucket.  The
reference's `jax.lax.scan` over EM boundaries is a Python loop here.

On the card the buckets' launches are independent (they read the same
frozen tables and write disjoint rows).  Where each launch runs more
than one sweep (B3's fused launches, B1's prediction pass) they go on
CUDA streams of their own, joined to the current stream before anything
queued after; B2's single sweeps run one after another on the current
stream (`_streams_for`).  The draws are the same either way.  On an H100
the streams were faster for multi-sweep launches in 15 of 18
comparisons and slower for single sweeps in 4 of 6 (PERF.md).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import ops, slda_predict, slda_train
from repro_torch.mathutil import chain_matvec, per_chain
from .regression import solve_eta
from .types import (BucketedCorpus, GibbsState, SLDAConfig, SLDAModel,
                    _stair_segments, _take_docs, _unstair_segments,
                    apply_count_deltas, bucket_corpus, bucket_signature,
                    counts_from_assignments)

EXECUTORS = ("blocks", "stair")

_stream_pool: dict = {}


# ------------------------------------------------------- canonicalization

def as_bucketed(corpus) -> BucketedCorpus:
    """The degenerate one-bucket schedule of a padded corpus (identity
    permutation, `ctr_stride = max_len`): the padded path as a plan cell.
    A `BucketedCorpus` passes through untouched."""
    if isinstance(corpus, BucketedCorpus):
        return corpus
    lead = tuple(corpus.tokens.shape[:-1])          # [D] or [M, D]
    perm = torch.arange(lead[-1], device=corpus.tokens.device).expand(lead)
    return BucketedCorpus(buckets=(corpus,), perm=perm, inv_perm=perm,
                          ctr_stride=corpus.tokens.shape[-1],
                          identity=True)


def build_schedule(corpus, cfg: SLDAConfig) -> BucketedCorpus:
    """The schedule `cfg` asks for: length buckets when
    `cfg.length_buckets > 0` (built from the corpus's lengths, read to
    the host), else the degenerate padded one.  A `BucketedCorpus` passes
    through, so callers may call this unconditionally."""
    if isinstance(corpus, BucketedCorpus):
        return corpus
    if cfg.length_buckets > 0:
        return bucket_corpus(corpus, cfg.length_buckets,
                             token_block=cfg.bucket_token_block,
                             overhead_docs=cfg.bucket_overhead_docs)
    return as_bucketed(corpus)


def _lift_chain(bc: BucketedCorpus) -> BucketedCorpus:
    """Flat schedule [D, ...] → chain-sharded [1, D, ...] (M = 1)."""
    if bc.n_chains is not None:
        return bc
    return BucketedCorpus(buckets=tuple(b.map(lambda x: x[None])
                                        for b in bc.buckets),
                          perm=bc.perm[None], inv_perm=bc.inv_perm[None],
                          ctr_stride=bc.ctr_stride, identity=bc.identity)


def build_plan(corpus, cfg: SLDAConfig, *, chained: bool = False,
               executor: str | None = None) -> "ExecutionPlan":
    """The plan for `(corpus, cfg)`.  `corpus` is a padded `Corpus` (flat
    or chain-sharded) or a `BucketedCorpus`; it is canonicalized, not
    re-bucketed (`build_schedule` does that).  `chained=True` lifts a
    flat corpus [D, N] to one chain [1, D, N] so that the chain-batched
    EM loop applies.  `executor` (the reference's `backend` argument)
    None takes the rule of `ExecutionPlan.executor`; "blocks" or "stair"
    forces one, and "stair" raises on a CUDA corpus, as the reference has
    no staircase route on its kernels."""
    bc = as_bucketed(corpus)
    if chained:
        bc = _lift_chain(bc)
    if executor is not None and executor not in EXECUTORS:
        raise ValueError(f"executor={executor!r}: expected one of "
                         f"{EXECUTORS} or None")
    if executor == "stair" and bc.perm.device.type != "cpu":
        raise ValueError("the stair executor runs on the CPU only; "
                         f"the corpus is on {bc.perm.device}")
    return ExecutionPlan(corpus=bc, cfg=cfg, forced_executor=executor)


def _stair_layout(bc: BucketedCorpus, m: int, vocab_size: int):
    """The doc-major chain fold of the staircase executors, shared by
    training and prediction: row r = d·M + c (a suffix of sorted documents
    stays a suffix of rows), each segment's first row and first token
    position, and the chains' offsets into the stacked [M·W, T] table.
    Returns (fold, unfold, sort, unsort, seg_r0, seg_n0, off): fold
    [M, D, ...] → [D·M, ...] and unfold back; sort / unsort original ↔
    sorted document order along axis 1."""
    def fold(a):
        return a.transpose(0, 1).reshape((-1,) + tuple(a.shape[2:]))

    def unfold(a):
        return a.reshape((-1, m) + tuple(a.shape[1:])).transpose(0, 1)

    def sort(a):
        return _take_docs(a, bc.perm, 1)

    def unsort(a):
        return _take_docs(a, bc.inv_perm, 1)

    starts = np.cumsum([0] + list(bc.counts))
    seg_r0 = [int(s) * m for s in starts[:-1]]
    seg_n0 = [0] + list(bc.widths[:-1])
    off = torch.arange(m, device=bc.perm.device) * vocab_size
    return fold, unfold, sort, unsort, seg_r0, seg_n0, off


def _stacked(table, index):
    """A word-major chain table [M, T, W] (`_word_major`) and its sparse
    index ([M, W, ·] each, or None) as the stacked [M·W, T] table and
    [M·W, ·] rows the staircase executors read."""
    M, T, W = table.shape
    rows = None if index is None else tuple(
        a.reshape(M * W, a.shape[-1]) for a in index)
    return table.transpose(-1, -2).reshape(M * W, T), rows


def _word_major(table):
    """A table [M, T, W] as a view of its contiguous transpose [M, W, T],
    the layout the kernels read: the ops then copy nothing, and one copy
    serves every bucket's launch."""
    return table.transpose(-1, -2).contiguous().transpose(-1, -2)


def _end_to_end(pieces):
    """Per-bucket [M, D_b, N_b] rows as one [M, 1, Σ D_b·N_b] row (one
    bucket stays as it is)."""
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat([p.reshape(p.shape[0], 1, -1) for p in pieces], -1)


def _streams_for(n_sweeps: int, n_calls: int, dev) -> bool:
    """Whether `n_calls` bucket launches of `n_sweeps` sweeps each go on
    CUDA streams of their own (see the module docstring)."""
    return dev.type == "cuda" and n_calls > 1 and n_sweeps > 1


def _on_streams(calls, dev):
    """Each call on a CUDA stream of its own, after the work queued so far
    on the current stream; the current stream waits for all of them
    before anything queued after.  Each call returns a tuple of tensors,
    which the current stream then owns."""
    main = torch.cuda.current_stream(dev)
    pool = _stream_pool.setdefault(dev, [])
    while len(pool) < len(calls):
        pool.append(torch.cuda.Stream(dev))
    outs = []
    for call, s in zip(calls, pool):
        s.wait_stream(main)
        with torch.cuda.stream(s):
            outs.append(call())
    for s in pool[:len(calls)]:
        main.wait_stream(s)
    for out in outs:
        for t in out:
            t.record_stream(main)
    return outs


# ----------------------------------------------------------------- plan

@dataclasses.dataclass
class ExecutionPlan:
    """A schedule — chain-sharded [M, D, N] for training, flat [D, N]
    (shared by every chain) for prediction — and its config."""

    corpus: BucketedCorpus
    cfg: SLDAConfig
    forced_executor: str | None = None

    @property
    def executor(self) -> str:
        """"stair" on the CPU over several buckets, "blocks" on the card and
        for one bucket (the reference's rule, with the device in place of
        its backend), unless `build_plan` forced one."""
        if self.forced_executor is not None:
            return self.forced_executor
        if self.device.type == "cpu" and len(self.corpus.buckets) > 1:
            return "stair"
        return "blocks"

    @property
    def n_chains(self):
        return self.corpus.n_chains

    @property
    def device(self) -> torch.device:
        return self.corpus.perm.device

    def sweep_schedule(self) -> tuple:
        """(sweeps_per_launch, n_full_launches, remainder_sweeps); the
        total number of sweeps is always cfg.n_iters."""
        spl = self.cfg.sweeps_per_launch
        if spl <= 1:
            return 1, self.cfg.n_iters, 0
        n_full, rem = divmod(self.cfg.n_iters, spl)
        return spl, n_full, rem

    def train_doc_block(self, n_bucket_docs: int) -> int:
        """A fused launch's doc block, clamped to its bucket's documents
        rounded up to a multiple of 8.  It is the delayed-count partition,
        so part of the semantics at sweeps_per_launch > 1."""
        return min(self.cfg.train_doc_block, -(-n_bucket_docs // 8) * 8)

    def n_boundaries(self) -> int:
        """EM boundaries (count refresh + η solve) of a training run: one
        per sweep at sweeps_per_launch=1, one per launch above — how often
        an `em_hook` sees the state, and how many draws `train_em` takes."""
        _, n_full, rem = self.sweep_schedule()
        return n_full + (1 if rem else 0)

    def cache_key(self) -> tuple:
        """What the plan's launches depend on: the schedule's shape
        signature (`types.bucket_signature`) and the config."""
        return (bucket_signature(self.corpus), self.cfg)

    def describe(self) -> dict:
        """The plan, readable: the schedule, the launches and the share of
        the source's token slots that are padding."""
        bc, cfg = self.corpus, self.cfg
        spl, n_full, rem = self.sweep_schedule()
        slot = bc.padded_tokens()                  # per chain
        real = float(bc.real_tokens()) / (self.n_chains or 1)
        src_slots = bc.n_docs * bc.ctr_stride
        return {
            "device": self.device.type,
            "executor": self.executor,
            "chains": self.n_chains or 1,
            "docs_per_chain": bc.n_docs,
            "buckets": len(bc.buckets),
            "bucket_widths": list(bc.widths),
            "bucket_counts": list(bc.counts),
            "ctr_stride": bc.ctr_stride,
            "sweeps_per_launch": spl,
            "launches": n_full + (1 if rem else 0),
            "remainder_sweeps": rem,
            "count_refresh": ("rebuild every "
                              f"{cfg.count_rebuild_every} launches"
                              if cfg.count_rebuild_every > 0
                              else "incremental deltas only"),
            "slot_tokens_per_sweep": int(slot),
            "real_tokens_per_sweep": int(real),
            "padded_slot_frac": round(1.0 - real / max(src_slots, 1), 4),
            "slot_vs_effective_tok_ratio": round(slot / max(real, 1.0), 3),
            "sampler_mode": cfg.sampler_mode,
            "sparse_topic_cap": min(cfg.sparse_topic_cap, cfg.n_topics),
            "bucket_streams": {
                "train": _streams_for(spl, len(bc.buckets), self.device),
                "predict": _streams_for(self._predict_sweeps(),
                                        len(bc.buckets), self.device)},
        }

    # ---- facts of the schedule, in original order, computed once

    @functools.cached_property
    def _lengths(self) -> torch.Tensor:
        return self.corpus.lengths().clamp(min=1.0)

    @functools.cached_property
    def _y(self) -> torch.Tensor:
        return self.corpus.y

    @functools.cached_property
    def _real_tokens(self) -> torch.Tensor:
        """Real tokens a chain [M] (the supervisor's count probe)."""
        return self.corpus.lengths().sum(-1)

    @functools.cached_property
    def _inv_len_b(self) -> list:
        return self.corpus.split_docs(1.0 / self._lengths)

    def _predict_sweeps(self) -> int:
        return self.cfg.n_pred_burnin + self.cfg.n_pred_samples

    def _launch(self, calls, n_sweeps: int):
        """One call a bucket, each launching `n_sweeps` sweeps: on streams
        of their own or in turn (`_streams_for`)."""
        if _streams_for(n_sweeps, len(calls), self.device):
            return _on_streams(calls, self.device)
        return [call() for call in calls]

    def _index(self, table):
        return ops.topic_index(table, self.cfg.sampler_mode,
                               self.cfg.sparse_topic_cap)

    @functools.cached_property
    def _flat_corpus(self):
        """Every bucket's tokens and mask end to end, [M, 1, Σ D_b·N_b]:
        one count refresh covers all buckets (the ±1 updates are exact in
        any order)."""
        return tuple(_end_to_end([getattr(b, f)
                                  for b in self.corpus.buckets])
                     for f in ("tokens", "mask"))

    def _counts(self, z_b):
        """Exact (ndt in original order, ntw, nt) of per-bucket topics."""
        cfg, pieces, ntw = self.cfg, [], None
        for b, zb in zip(self.corpus.buckets, z_b):
            nd, nw, _ = counts_from_assignments(b.tokens, b.mask, zb,
                                                cfg.n_topics, cfg.vocab_size)
            pieces.append(nd)
            ntw = nw if ntw is None else ntw + nw   # integer adds: exact
        return self.corpus.merge_docs(pieces), ntw, ntw.sum(-1)

    # ---- the chain-batched EM loop

    def init_states(self, z_init) -> GibbsState:
        """The state before the first sweep, from the initial topics
        z_init [M, D, ctr_stride] in original order (drawn at the padded
        shape): state.z the tuple of per-bucket topics [M, D_b, N_b]
        (`corpus.merge_padded(state.z, z_init)` gives them back in the
        padded layout), state.ndt [M, D, T] in original order, the counts
        derived exactly from z, η at its prior mean."""
        cfg = self.cfg
        z_b = tuple(self.corpus.split_padded(z_init))
        ndt, ntw, nt = self._counts(z_b)
        eta = torch.full((z_init.shape[0], cfg.n_topics), cfg.mu,
                         dtype=torch.float32, device=z_init.device)
        return GibbsState(z=z_b, ndt=ndt, ntw=ntw, nt=nt, eta=eta)

    def _refresh_and_solve(self, z_new_b, ndt, state, rebuild_now: bool):
        """THE EM boundary: exact global count refresh — full rebuild or
        incremental (z_old, z_new) deltas, both exact — then the per-chain
        η ridge solve on original-order rows."""
        if rebuild_now:
            ndt, ntw, nt = self._counts(z_new_b)
        else:
            ntw, nt = apply_count_deltas(state.ntw, state.nt,
                                         *self._flat_corpus,
                                         _end_to_end(state.z),
                                         _end_to_end(z_new_b))
        eta = solve_eta(ndt / self._lengths[..., None], self._y, self.cfg)
        return GibbsState(z=tuple(z_new_b), ndt=ndt, ntw=ntw, nt=nt,
                          eta=eta)

    def _seed_sweep(self, state, ntw, uniforms, index):
        """One sweep of every chain under the uniforms [M, D, ctr_stride]
        (original order) against the table `ntw` (`_word_major`): one
        kernel-B2 launch a bucket on the card."""
        bc, cfg = self.corpus, self.cfg
        calls = [functools.partial(
            ops.slda_gibbs_sweep, b.tokens, b.mask, ub, zb, ndb, b.y, ilb,
            ntw, state.nt, state.eta, alpha=cfg.alpha, beta=cfg.beta,
            rho=cfg.rho, supervised=True, sampler_mode=cfg.sampler_mode,
            sparse_topic_cap=cfg.sparse_topic_cap, topic_index=index)
            for b, ub, zb, ndb, ilb in zip(
                bc.buckets, bc.split_padded(uniforms), state.z,
                bc.split_docs(state.ndt), self._inv_len_b)]
        z_new_b, ndt_b = zip(*self._launch(calls, 1))
        return list(z_new_b), bc.merge_docs(ndt_b)

    def _blocks_launch(self, state, ntw, seeds, n_sweeps: int, index):
        """One fused launch of `n_sweeps` sweeps a bucket over every
        chain, from the per-document seeds [M, D] (original order) and
        with the counter stride pinned to the source's max_len (one
        kernel-B3 launch a bucket on the card)."""
        bc, cfg = self.corpus, self.cfg
        calls = [functools.partial(
            ops.slda_train_sweeps, b.tokens, b.mask, zb, ndb, b.y, ilb,
            ntw, state.nt, state.eta, sb, alpha=cfg.alpha,
            beta=cfg.beta, rho=cfg.rho, n_sweeps=n_sweeps,
            doc_block=self.train_doc_block(b.tokens.shape[-2]),
            supervised=True, product_form=cfg.product_form_sweeps,
            ctr_stride=bc.ctr_stride, sampler_mode=cfg.sampler_mode,
            sparse_topic_cap=cfg.sparse_topic_cap, topic_index=index)
            for b, zb, ndb, sb, ilb in zip(
                bc.buckets, state.z, bc.split_docs(state.ndt),
                bc.split_docs(seeds), self._inv_len_b)]
        z_new_b, ndt_b = zip(*self._launch(calls, n_sweeps))
        return list(z_new_b), bc.merge_docs(ndt_b)

    @functools.cached_property
    def _stair_staging(self) -> dict:
        """What a staircase training launch reads of the schedule, folded
        once: the token (offset into the stacked table) and mask segments,
        each row's chain, y and 1/len in sorted order."""
        bc = self.corpus
        M, W = bc.n_chains, self.cfg.vocab_size
        fold, unfold, sort, unsort, seg_r0, seg_n0, off = _stair_layout(
            bc, M, W)
        return dict(
            fold=fold, unfold=unfold, sort=sort, unsort=unsort,
            seg_r0=seg_r0, seg_n0=seg_n0,
            tok_segs=[fold(s + off[:, None, None]) for s in _stair_segments(
                bc, [b.tokens for b in bc.buckets])],
            mask_segs=[fold(s) for s in _stair_segments(
                bc, [b.mask for b in bc.buckets])],
            chain_of_row=torch.arange(M, device=self.device).repeat(
                bc.n_docs),
            y_f=fold(torch.cat([b.y for b in bc.buckets], 1)),
            il_f=fold(torch.cat(self._inv_len_b, 1)))

    def _stair_launch(self, state, ntw, seeds, n_sweeps: int, index):
        """One staircase launch of `n_sweeps` sweeps over every chain and
        bucket, from the per-document seeds [M, D] (original order), with
        the counter stride pinned to the source's max_len: the CPU route
        over several buckets (`slda_train.slda_train_stair`)."""
        bc, cfg, st = self.corpus, self.cfg, self._stair_staging
        fold, unfold, sort = st["fold"], st["unfold"], st["sort"]
        table, rows = _stacked(ntw, index)
        z_segs, ndt_f = slda_train.slda_train_stair(
            st["tok_segs"], st["mask_segs"],
            [fold(z) for z in _stair_segments(bc, state.z)], st["seg_r0"],
            st["seg_n0"], fold(sort(seeds)), fold(sort(state.ndt)),
            st["y_f"], st["il_f"], table, state.nt, state.eta,
            st["chain_of_row"], alpha=cfg.alpha, beta=cfg.beta,
            rho=cfg.rho, vocab_size=cfg.vocab_size,
            ctr_stride=bc.ctr_stride, n_sweeps=n_sweeps, supervised=True,
            product_form=cfg.product_form_sweeps, topic_index=rows)
        z_new_b = _unstair_segments(bc, [unfold(z) for z in z_segs])
        return z_new_b, st["unsort"](unfold(ndt_f))

    def _rebuild_now(self, it: int) -> bool:
        every = self.cfg.count_rebuild_every
        return every > 0 and it % every == 0

    def train_em(self, state0: GibbsState, draws, *, em_hook=None,
                 status0=None, it_offset: int = 0):
        """The stochastic-EM loop, `cfg.n_iters` Gibbs sweeps in all.  At
        sweeps_per_launch=1 each iteration is one sweep under its uniforms
        f32 [M, D, ctr_stride]; above, each EM boundary follows one fused
        launch under its per-document seeds int32 [M, D], with a remainder
        launch of the leftover sweeps.  `draws` yields one tensor per EM
        boundary (`n_boundaries()` of them, `rng.train_draws`), in
        original order.  Each boundary is the exact count refresh (a full
        rebuild every `cfg.count_rebuild_every` boundaries, ±1 deltas in
        between) and the η solve.

        `em_hook(state, it, status) -> (state, status)`, when given, is
        called at every EM boundary `it` (the supervisor's attachment
        point); `train_em` then returns `(state, status)`, else `state`.
        `it` is the boundary's index plus `it_offset`, which offsets the
        rebuild cadence too, so that a loop run round by round (the
        supervisor's) sees the boundaries and rebuilds of one run."""
        spl, n_full, rem = self.sweep_schedule()
        sizes = [spl] * n_full + ([rem] if rem else [])
        state, status, it = state0, status0, -1
        for it, (n_sweeps, draw) in enumerate(zip(sizes, draws)):
            ntw = _word_major(state.ntw)
            index = self._index(ntw)
            if spl == 1:
                z_new, ndt = self._seed_sweep(state, ntw, draw, index)
            elif self.executor == "stair":
                z_new, ndt = self._stair_launch(state, ntw, draw, n_sweeps,
                                                index)
            else:
                z_new, ndt = self._blocks_launch(state, ntw, draw, n_sweeps,
                                                 index)
            state = self._refresh_and_solve(
                z_new, ndt, state, self._rebuild_now(it + it_offset))
            if em_hook is not None:
                state, status = em_hook(state, it + it_offset, status)
        if it + 1 != len(sizes):
            raise ValueError(f"{it + 1} draws for {len(sizes)} EM "
                             "boundaries")
        return state if em_hook is None else (state, status)

    def _export(self, state: GibbsState) -> SLDAModel:
        """Per-chain (φ̂, η̂, train MSE/acc) — what crosses the chain
        boundary; original-order rows."""
        from .gibbs import phi_hat
        zb = state.ndt / self._lengths[..., None]
        yhat = chain_matvec(zb, state.eta)
        y = self._y
        # the mean over a chain's documents, chain by chain: the card's
        # reduction orders its sums by the number of rows (ROADMAP C7);
        # the accuracy sums 0/1 values, exact in any order
        mse = per_chain(lambda a, b: ((a - b) ** 2).mean(-1), yhat, y)
        acc = ((yhat > 0.5) == (y > 0.5)).to(torch.float32).mean(-1)
        return SLDAModel(phi=phi_hat(state, self.cfg), eta=state.eta,
                         train_mse=mse, train_acc=acc)

    def train(self, z_init, draws):
        """Full chain-batched training from explicit draws (`core.rng`):
        the initial topics [M, D, ctr_stride] and the EM loop's
        per-boundary draws, in original order.  Returns (GibbsState,
        SLDAModel), each with leading chain dim; state.z is merged back to
        [M, D, ctr_stride] in original order, padding slots as drawn."""
        if self.n_chains is None:
            raise ValueError("train wants a chain-sharded corpus "
                             "(build_plan(..., chained=True))")
        state = self.train_em(self.init_states(z_init), draws)
        models = self._export(state)
        return dataclasses.replace(
            state, z=self.corpus.merge_padded(state.z, z_init)), models

    # ---- prediction

    def predict_zbar(self, z0, seeds, models: SLDAModel):
        """Per-chain posterior-mean topic mixtures z̄ [M, D, T] of every
        document of the plan's (shared) corpus, in original order, from
        explicit initial topics z0 [M, D, ctr_stride] and per-document
        seeds [M, D]: one kernel-B1 launch a bucket on the card."""
        if self.n_chains is not None:
            raise ValueError("predict wants a shared (flat) corpus")
        phi = _word_major(models.phi)
        index = self._index(phi)
        run = (self._predict_stair if self.executor == "stair"
               else self._predict_blocks)
        return run(phi, index, z0, seeds) / self._lengths[:, None]

    def _predict_blocks(self, phi, index, z0, seeds):
        """The blocks prediction executor: one B1 launch a bucket over
        every chain.  Returns ndt_avg [M, D, T] in original order."""
        bc, cfg = self.corpus, self.cfg
        M = z0.shape[0]
        calls = []
        for b, z0b, sb in zip(bc.buckets, bc.split_padded(z0, d_axis=1),
                              bc.split_docs(seeds, d_axis=1)):
            ndt0, _, _ = counts_from_assignments(
                b.tokens.expand(M, -1, -1), b.mask.expand(M, -1, -1), z0b,
                cfg.n_topics, cfg.vocab_size)
            calls.append(functools.partial(
                ops.slda_predict_sweeps, b.tokens, b.mask, z0b, ndt0, phi,
                sb, alpha=cfg.alpha, n_burnin=cfg.n_pred_burnin,
                n_samples=cfg.n_pred_samples, ctr_stride=bc.ctr_stride,
                sampler_mode=cfg.sampler_mode,
                sparse_topic_cap=cfg.sparse_topic_cap, topic_index=index))
        return bc.merge_docs(
            [avg for avg, _ in self._launch(calls, self._predict_sweeps())],
            d_axis=1)

    def _predict_stair(self, phi, index, z0, seeds):
        """The staircase prediction executor, the CPU route over several
        buckets (`slda_predict.slda_predict_stair`): the shared corpus
        broadcast to every chain, folded doc-major around the stacked
        φ̂.  Returns ndt_avg [M, D, T] in original order."""
        bc, cfg = self.corpus, self.cfg
        M, T = z0.shape[0], cfg.n_topics
        fold, _, sort, _, seg_r0, seg_n0, off = _stair_layout(
            bc, M, cfg.vocab_size)
        table, rows = _stacked(phi, index)
        z0_b = bc.split_padded(z0, d_axis=1)          # [M, D_b, N_b] sorted
        ndt0 = torch.cat([counts_from_assignments(
            b.tokens.expand(M, -1, -1), b.mask.expand(M, -1, -1), zb, T,
            cfg.vocab_size)[0] for b, zb in zip(bc.buckets, z0_b)], 1)
        seg_tok = [(tk.long()[:, None, :] + off[None, :, None])
                   .reshape(-1, tk.shape[-1])
                   for tk in _stair_segments(bc, [b.tokens
                                                  for b in bc.buckets])]
        seg_mask = [mk[:, None, :].expand(-1, M, -1).reshape(
            -1, mk.shape[-1])
            for mk in _stair_segments(bc, [b.mask for b in bc.buckets])]
        avg_f = slda_predict.slda_predict_stair(
            seg_tok, seg_mask, [fold(z) for z in _stair_segments(bc, z0_b)],
            seg_r0, seg_n0, fold(sort(seeds)), fold(ndt0), table,
            alpha=cfg.alpha, n_burnin=cfg.n_pred_burnin,
            n_samples=cfg.n_pred_samples, ctr_stride=bc.ctr_stride,
            topic_index=rows)
        avg = avg_f.reshape(bc.n_docs, M, T).transpose(0, 1)
        return _take_docs(avg, bc.inv_perm, 1)

    def predict(self, z0, seeds, models: SLDAModel):
        """Every chain predicts every document → ŷ [M, D] (Eq. 5)."""
        zb = self.predict_zbar(z0, seeds, models)
        return chain_matvec(zb, models.eta)
