"""Ragged, length-bucketed execution against the reference: the schedules
bit for bit, the row plumbing, bucketed runs against padded ones per
document at one sweep per launch, and bucketed runs against the
reference's bucketed plan under its own draws."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import SLDAConfig as JConfig
from repro.core import plan as jplan
from repro.core import types as jtypes
from repro_torch.convert import model_from_numpy
from repro_torch.core import (ALGORITHMS, SLDAConfig, as_bucketed,
                              bucket_corpus, bucket_signature,
                              build_schedule, counts_from_assignments,
                              partition, rng)
from repro_torch.core import plan as pplan
from repro_torch.core import types as ptypes
from repro_torch.core.plan import build_plan
from repro_torch.kernels import slda_train
from test_torch_parallel import _ref_predict_draws, _ref_train_draws
from test_torch_train import _ref_fused_draws

MISMATCH_MAX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lengths_corpus(seed, lead, n=40, w=60):
    """The same numpy-made corpus in both packages: log-normal lengths in
    [1, n] over `lead` = (D,) or (M, D) documents."""
    rng_ = np.random.default_rng(seed)
    lens = np.clip(np.round(rng_.lognormal(np.log(n / 4), 0.75, lead)), 1, n)
    mask = (np.arange(n) < lens[..., None]).astype(np.float32)
    tokens = rng_.integers(0, w, lead + (n,)).astype(np.int32)
    y = rng_.normal(size=lead).astype(np.float32)
    return (jtypes.Corpus(*map(jnp.asarray, (tokens, mask, y))),
            ptypes.Corpus(*map(torch.from_numpy, (tokens, mask, y))))


def _same_schedule(j_bc, p_bc):
    assert p_bc.widths == j_bc.widths and p_bc.counts == j_bc.counts
    assert p_bc.ctr_stride == j_bc.ctr_stride
    for a, b in ((j_bc.perm, p_bc.perm), (j_bc.inv_perm, p_bc.inv_perm)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for jb, pb in zip(j_bc.buckets, p_bc.buckets):
        for f in ("tokens", "mask", "y"):
            np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                          np.asarray(getattr(jb, f)))


# ----------------------------------------------------------- schedules

@pytest.mark.parametrize("overhead", [0.0, 96.0])
@pytest.mark.parametrize("n_buckets", [1, 3, 8, 12])
@pytest.mark.parametrize("lead", [(150,), (3, 60)])
def test_bucket_corpus_matches_reference(lead, n_buckets, overhead):
    """widths, counts, perm, inv_perm and every bucket's rows, bit for bit,
    flat and chain-sharded."""
    j_c, p_c = _lengths_corpus(len(lead) * 10 + n_buckets, lead)
    j_bc = jtypes.bucket_corpus(j_c, n_buckets, overhead_docs=overhead)
    p_bc = bucket_corpus(p_c, n_buckets, overhead_docs=overhead)
    _same_schedule(j_bc, p_bc)
    assert bucket_signature(p_bc) == jtypes.bucket_signature(j_bc)
    if n_buckets > 1 and overhead == 0.0:
        assert len(p_bc.buckets) > 1


segs_strategy = st.lists(st.integers(1, 50), min_size=1, max_size=12).map(
    lambda cs: [(c, 8 * (i + 1)) for i, c in enumerate(cs)])


@settings(max_examples=60, deadline=None)
@given(segs=segs_strategy, max_b=st.integers(1, 10),
       overhead=st.sampled_from([0.0, 1.0, 17.5, 96.0]))
def test_dp_bucket_cuts_matches_reference(segs, max_b, overhead):
    assert ptypes._dp_bucket_cuts(segs, max_b, overhead) == \
        jtypes._dp_bucket_cuts(segs, max_b, overhead)


def test_degenerate_corpora_collapse_as_reference():
    """All documents of one length: one bucket; fewer documents than
    buckets; the padded wrap: one identity bucket."""
    rng_ = np.random.default_rng(3)
    tokens = rng_.integers(0, 30, (9, 16)).astype(np.int32)
    y = rng_.normal(size=9).astype(np.float32)
    for mask in (np.ones((9, 16), np.float32),
                 (np.arange(16) < rng_.integers(1, 17, (9, 1))).astype(
                     np.float32)):
        j_c = jtypes.Corpus(*map(jnp.asarray, (tokens, mask, y)))
        p_c = ptypes.Corpus(*map(torch.from_numpy, (tokens, mask, y)))
        for nb in (1, 5, 20):
            _same_schedule(jtypes.bucket_corpus(j_c, nb, overhead_docs=0),
                           bucket_corpus(p_c, nb, overhead_docs=0))
    p_bc = bucket_corpus(ptypes.Corpus(*map(torch.from_numpy, (
        tokens, np.ones((9, 16), np.float32), y))), 8)
    assert p_bc.counts == (9,) and p_bc.widths == (16,)
    wrap = as_bucketed(p_c)
    assert wrap.identity and wrap.split_docs(p_c.tokens)[0] is p_c.tokens
    assert wrap.split_padded(p_c.mask)[0] is p_c.mask


def test_describe_schedule_fields_match_reference():
    j_c, p_c = _lengths_corpus(5, (4, 60))
    cfg = dict(n_topics=6, vocab_size=60, n_iters=7, sweeps_per_launch=3,
               length_buckets=4, bucket_overhead_docs=0.0)
    j_d = jplan.build_plan(jplan.build_schedule(j_c, JConfig(**cfg)),
                           JConfig(**cfg), backend="jnp").describe()
    p_plan = build_plan(build_schedule(p_c, SLDAConfig(**cfg)),
                        SLDAConfig(**cfg))
    p_d = p_plan.describe()
    for k in ("chains", "docs_per_chain", "buckets", "bucket_widths",
              "bucket_counts", "ctr_stride", "sweeps_per_launch",
              "launches", "remainder_sweeps", "count_refresh",
              "slot_tokens_per_sweep", "real_tokens_per_sweep",
              "padded_slot_frac", "slot_vs_effective_tok_ratio",
              "sampler_mode", "sparse_topic_cap"):
        assert p_d[k] == j_d[k], k
    assert p_d["executor"] == "blocks" and p_d["buckets"] > 1
    assert p_d["bucket_streams"] == {"train": False, "predict": False}
    assert p_plan.cache_key()[0] == jtypes.bucket_signature(
        jplan.build_schedule(j_c, JConfig(**cfg)))


@pytest.mark.parametrize("n_sweeps,n_calls,device,want", [
    (8, 8, "cuda", True), (25, 3, "cuda", True), (1, 8, "cuda", False),
    (8, 1, "cuda", False), (8, 8, "cpu", False)])
def test_bucket_launches_take_streams_for_multi_sweep_launches(
        n_sweeps, n_calls, device, want):
    """Several buckets' launches of more than one sweep each go on CUDA
    streams of their own; single sweeps, a lone bucket and the CPU run
    in turn."""
    assert pplan._streams_for(n_sweeps, n_calls,
                              torch.device(device)) is want


@pytest.mark.parametrize("lead", [(50,), (3, 50)])
def test_row_plumbing_round_trips(lead):
    """split_docs / merge_docs and split_padded / merge_padded are exact
    inverses; the padded slots past a bucket's width come from the fill."""
    _, p_c = _lengths_corpus(7, lead)
    bc = bucket_corpus(p_c, 4, overhead_docs=0)
    assert len(bc.buckets) > 1
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(lead + (5,), generator=g)
    assert torch.equal(bc.merge_docs(bc.split_docs(rows)), rows)
    full = torch.randn(lead + (40,), generator=g)
    pieces = bc.split_padded(full)
    assert [p.shape[-1] for p in pieces] == list(bc.widths)
    assert all(p.is_contiguous() for p in pieces)
    assert torch.equal(bc.merge_padded(pieces, full), full)
    fill = torch.randn(lead + (40,), generator=g)
    merged = bc.merge_padded(pieces, fill)
    assert torch.equal(merged * p_c.mask, full * p_c.mask)
    assert torch.equal(bc.lengths(), p_c.lengths())
    assert torch.equal(bc.y, p_c.y)
    # a shared (flat) schedule splits chain-led rows along axis 1
    if len(lead) == 1:
        chains = torch.randn((3,) + lead + (40,), generator=g)
        back = bc.merge_padded(bc.split_padded(chains, d_axis=1), chains,
                               d_axis=1)
        assert torch.equal(back, chains)


@pytest.mark.parametrize("d_b", range(1, 9))
def test_small_tail_buckets_take_each_document_once(d_b):
    """A tail bucket of a few long documents: B3's slot plan at the
    slice's T over D_b = 1..8 documents, with the plan's doc block."""
    plan = build_plan(as_bucketed(ptypes.Corpus(
        torch.zeros((1, d_b, 8), dtype=torch.int32), torch.ones((1, d_b, 8)),
        torch.zeros((1, d_b)))), SLDAConfig(n_topics=16))
    doc_block = plan.train_doc_block(d_b)
    assert doc_block == 8
    walks = slda_train.walks(d_b, doc_block, 16, "cluster")
    taken = walks[walks >= 0]
    assert sorted(taken.tolist()) == list(range(d_b))


# -------------------------------- bucketed equals padded, per document

@pytest.fixture(scope="module")
def corpus_pair():
    """A numpy-made corpus of log-normal lengths, 128 training documents
    and 32 test ones, in both packages."""
    (j_tr, p_tr), (j_te, p_te) = (_lengths_corpus(s, (d,), n=32)
                                  for s, d in ((20, 128), (21, 32)))
    return (j_tr, j_te), (p_tr, p_te)


CFG = dict(n_topics=6, vocab_size=60, n_iters=5, rho=0.25, n_pred_burnin=2,
           n_pred_samples=2, count_rebuild_every=2, sparse_topic_cap=3)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("m", [1, 4])
def test_bucketed_plan_equals_padded_per_document(corpus_pair, m, mode):
    """spl=1: training's z, ndt, ntw, nt, η and model, and prediction's ŷ,
    bit for bit, under the same draws."""
    _, (train, test) = corpus_pair
    cfg = SLDAConfig(**CFG, sampler_mode=mode)
    shards = partition(train, m)
    bucketed = bucket_corpus(shards, 4, overhead_docs=0)
    assert len(bucketed.buckets) > 1
    out = []
    for sched in (shards, bucketed):
        z, draws = rng.train_draws(rng.chain_generators(1, m, "cpu"),
                                   shards.n_docs, shards.max_len, 6,
                                   cfg.n_iters)
        state, models = build_plan(sched, cfg).train(z, draws)
        z0, seeds = rng.predict_draws(rng.chain_generators(2, m, "cpu"),
                                      test.n_docs, test.max_len, 6)
        yhat = build_plan(bucket_corpus(test, 3, overhead_docs=0)
                          if sched is bucketed else test, cfg).predict(
            z0, seeds, models)
        out.append((state, models, yhat))
    (s_p, m_p, y_p), (s_b, m_b, y_b) = out
    for f in ("z", "ndt", "ntw", "nt", "eta"):
        assert torch.equal(getattr(s_b, f), getattr(s_p, f)), f
    for f in ("phi", "eta", "train_mse", "train_acc"):
        assert torch.equal(getattr(m_b, f), getattr(m_p, f)), f
    assert torch.equal(y_b, y_p)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_bucketed_algorithms_equal_padded(corpus_pair, mode):
    """The four algorithms' ŷ through their entry points at spl=1:
    `length_buckets` 4 against the padded run, bit for bit."""
    _, (train, test) = corpus_pair
    cfg = SLDAConfig(**CFG, sampler_mode=mode)
    cfg_b = dataclasses.replace(cfg, length_buckets=4)
    for name, fn in ALGORITHMS.items():
        m = () if name == "nonparallel" else (4,)
        y_p = fn(3, train, test, cfg, *m, device="cpu")
        y_b = fn(3, train, test, cfg_b, *m, device="cpu")
        assert torch.equal(y_b, y_p), name


# ------------------------- against the reference's plan, its own draws

@pytest.mark.parametrize("spl", [1, 4])
def test_bucketed_train_with_reference_draws_matches_reference(corpus_pair,
                                                               spl):
    """Bucketed training under the reference's draws against the
    reference's bucketed plan — at spl 4 on its `pallas-interpret`
    backend, the blocks executor the port runs — with the draws within
    the mismatch rule, counts exact, η and φ̂ close; at spl 1 the
    bucketed prediction too."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    kw = dict(CFG, n_iters=5, sweeps_per_launch=spl,
              length_buckets=3, bucket_overhead_docs=0.0)
    j_cfg, p_cfg = JConfig(**kw, use_pallas=spl > 1), SLDAConfig(**kw)
    j_sched = jplan.build_schedule(jtypes.partition(j_train, 4), j_cfg)
    p_sched = build_schedule(partition(p_train, 4), p_cfg)
    _same_schedule(j_sched, p_sched)
    backend = "pallas-interpret" if spl > 1 else "jnp"
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    j_state, j_models = jax.jit(lambda k, c: jplan.build_plan(
        c, j_cfg, backend).train(k))(keys, j_sched)
    z, draws = (_ref_train_draws(keys, 32, 32, 6, kw["n_iters"]) if spl == 1
                else _ref_fused_draws(keys, 32, 32, 6,
                                      -(-kw["n_iters"] // spl)))
    p_state, p_models = build_plan(p_sched, p_cfg).train(
        _t(z), (_t(d) for d in draws))
    shards = partition(p_train, 4)
    mask = shards.mask.numpy()
    rate = float(((p_state.z.numpy() != np.asarray(j_state.z)) * mask).sum()
                 / mask.sum())
    print(f"bucketed training at spl {spl} under the reference's draws: "
          f"draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    counts = counts_from_assignments(shards.tokens, shards.mask, p_state.z,
                                     6, 60)
    for f, c in zip(("ndt", "ntw", "nt"), counts):
        assert torch.equal(getattr(p_state, f), c)
    np.testing.assert_allclose(p_models.eta.numpy(),
                               np.asarray(j_models.eta), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_models.phi.numpy(),
                               np.asarray(j_models.phi), rtol=1e-3, atol=1e-6)
    if spl > 1:
        return
    pkeys = jax.random.split(jax.random.PRNGKey(5), 4)
    j_test_b = jplan.build_schedule(j_test, j_cfg)
    j_yhat = jax.jit(lambda k, c, m: jplan.build_plan(c, j_cfg).predict(
        k, m))(pkeys, j_test_b, j_models)
    z0, seeds = _ref_predict_draws(pkeys, 32, 32, 6)
    p_yhat = build_plan(build_schedule(p_test, p_cfg), p_cfg).predict(
        _t(z0), _t(seeds), model_from_numpy(
            j_models.phi, j_models.eta, j_models.train_mse,
            j_models.train_acc, device="cpu"))
    np.testing.assert_allclose(p_yhat.numpy(), np.asarray(j_yhat),
                               rtol=1e-4, atol=1e-4)
