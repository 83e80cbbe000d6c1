"""The port's data types and count helpers against the reference."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.data import make_slda_corpus as jmake
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import types
from repro_torch.data import (make_slda_corpus, shuffle_corpus,
                               train_test_split)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _corpus(seed=0, d=24, w=50, n=20):
    """The same numpy-made corpus as the reference's and the port's."""
    rng = np.random.default_rng(seed)
    arrays = (rng.integers(0, w, (d, n)).astype(np.int32),
              (rng.random((d, n)) < 0.8).astype(np.float32),
              rng.normal(size=d).astype(np.float32))
    return (jtypes.Corpus(*map(jax.numpy.asarray, arrays)),
            corpus_from_numpy(*arrays, device="cpu"))


def test_config_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(jtypes.SLDAConfig)}
    port = {f.name: f.default for f in dataclasses.fields(types.SLDAConfig)}
    assert port == ref


@pytest.mark.parametrize("kw", [dict(length_buckets=4)])
def test_config_paths_not_ported_raise(kw):
    """The one setting that raised, ragged buckets, is ported: it builds,
    and its schedule has buckets."""
    cfg = types.SLDAConfig(**kw)
    assert cfg.length_buckets == 4
    _, corpus = _corpus()
    assert len(types.bucket_corpus(corpus, cfg.length_buckets,
                                   overhead_docs=0).buckets) > 1


def test_fused_training_config_builds():
    """sweeps_per_launch > 1 is ported (kernel B3), and with ragged
    buckets beside it."""
    cfg = types.SLDAConfig(sweeps_per_launch=8)
    assert cfg.sweeps_per_launch == 8 and cfg.product_form_sweeps
    cfg = types.SLDAConfig(sweeps_per_launch=8, length_buckets=4)
    assert cfg.length_buckets == 4


def test_sparse_config_builds():
    """The sparse sampler is ported (kernel B4) at one and several sweeps
    per launch, and with ragged buckets beside it; an unknown sampler mode
    is refused."""
    for spl in (1, 8):
        cfg = types.SLDAConfig(sampler_mode="sparse", sparse_topic_cap=4,
                               sweeps_per_launch=spl, length_buckets=4)
        assert cfg.sampler_mode == "sparse" and cfg.sparse_topic_cap == 4
    with pytest.raises(ValueError, match="sampler_mode"):
        types.SLDAConfig(sampler_mode="stair")


@pytest.mark.parametrize("chains", [None, 3])
def test_counts_from_assignments_exact(chains):
    rng = np.random.default_rng(0)
    shape = (24, 20) if chains is None else (chains, 8, 20)
    tok = rng.integers(0, 50, shape).astype(np.int32)
    mask = (rng.random(shape) < 0.7).astype(np.float32)
    z = rng.integers(0, 8, shape).astype(np.int32)
    fn = lambda t, m, zz: jtypes.counts_from_assignments(t, m, zz, 8, 50)
    want = fn(tok, mask, z) if chains is None else jax.vmap(fn)(tok, mask, z)
    got = types.counts_from_assignments(*map(torch.from_numpy, (tok, mask, z)),
                                        8, 50)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), _np(w))


def test_apply_count_deltas_exact():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 50, (3, 8, 20)).astype(np.int32)
    mask = (rng.random(tok.shape) < 0.7).astype(np.float32)
    z_old = rng.integers(0, 8, tok.shape).astype(np.int32)
    z_new = np.where(rng.random(tok.shape) < 0.3,
                     rng.integers(0, 8, tok.shape), z_old).astype(np.int32)
    _, ntw, nt = jax.vmap(lambda t, m, zz: jtypes.counts_from_assignments(
        t, m, zz, 8, 50))(tok, mask, z_old)
    want = jax.vmap(lambda a, b, t, m, zo, zn: jtypes.apply_count_deltas(
        a, b, t, m, zo, zn, cap=0))(ntw, nt, tok, mask, z_old, z_new)
    got = types.apply_count_deltas(
        *map(torch.tensor, (_np(ntw), _np(nt), tok, mask, z_old, z_new)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), _np(w))
    # and the refreshed tables are the counts of z_new, exactly
    _, ntw2, nt2 = types.counts_from_assignments(
        *map(torch.from_numpy, (tok, mask, z_new)), 8, 50)
    assert torch.equal(got[0], ntw2) and torch.equal(got[1], nt2)


def test_partition_and_concat_match_reference():
    jc, pc = _corpus()
    jp, pp = jtypes.partition(jc, 4), types.partition(pc, 4)
    for f in ("tokens", "mask", "y"):
        assert np.array_equal(getattr(pp, f).numpy(), _np(getattr(jp, f)))
    with pytest.raises(ValueError):
        types.partition(pc, 5)
    jc2, pc2 = _corpus(seed=1, d=8, n=12)
    jcat = jtypes._concat_corpora(jc2, jc)
    pcat = types._concat_corpora(pc2, pc)
    for f in ("tokens", "mask", "y"):
        assert np.array_equal(getattr(pcat, f).numpy(), _np(getattr(jcat, f)))


@pytest.mark.parametrize("dist", ["uniform", "lognormal"])
def test_corpus_generator_statistics_match_reference(dist):
    """Different generators, same distribution: lengths, padding, labels."""
    kw = dict(rho=0.25, doc_len_dist=dist)
    make = jax.jit(jmake, static_argnums=(1, 2, 3, 4),
                   static_argnames=tuple(kw))
    jc, _ = make(jax.random.PRNGKey(3), 2000, 300, 8, 60, **kw)
    pc, eta = make_slda_corpus(3, 2000, 300, 8, 60, device="cpu", **kw)
    assert pc.tokens.dtype == torch.int32 and pc.mask.dtype == torch.float32
    assert tuple(pc.tokens.shape) == (2000, 60) and tuple(eta.shape) == (8,)
    assert int(pc.tokens.min()) >= 0 and int(pc.tokens.max()) < 300
    jl, pl = _np(jc.mask).sum(-1), pc.mask.sum(-1).numpy()
    assert abs(pl.mean() - jl.mean()) < 0.05 * jl.mean()
    assert abs(np.median(pl) - np.median(jl)) <= 0.1 * np.median(jl)
    assert pl.min() >= min(jl.min(), 30 if dist == "uniform" else 4)
    assert abs(float(pc.mask.mean()) - float(_np(jc.mask).mean())) < 0.03
    # the spread of y follows η ~ N(0, 2²) and ρ: same order, not equal
    assert 0.5 < float(pc.y.std()) / float(_np(jc.y).std()) < 2.0
    tr, te = train_test_split(pc, 1500)
    assert tr.n_docs == 1500 and te.n_docs == 500


def test_binary_labels_split_at_median():
    pc, _ = make_slda_corpus(0, 200, 100, 4, 20, label_type="binary",
                             device="cpu")

    assert set(pc.y.unique().tolist()) == {0.0, 1.0}
    assert float(pc.y.mean()) == 0.5


def test_shuffle_corpus_permutes_documents():
    _, pc = _corpus(seed=5)
    sh = shuffle_corpus(3, pc)
    assert torch.equal(sh.y, shuffle_corpus(3, pc).y)
    perm = [int(torch.nonzero(pc.y == v)[0]) for v in sh.y]
    assert sorted(perm) == list(range(pc.n_docs))
    assert torch.equal(sh.tokens, pc.tokens[perm])
    assert torch.equal(sh.mask, pc.mask[perm])
