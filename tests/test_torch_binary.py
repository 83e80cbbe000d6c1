"""Figure 7's binary labels: the four algorithms with
`label_type="binary"` against the reference, under the reference's own
draws and over seeds, and `repro_torch.fig7_imdb`'s configuration against
the reference harness's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Corpus as JCorpus
from repro.core import SLDAConfig as JConfig
from repro.core import parallel as jpar
from repro.core.types import partition as j_partition
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import ALGORITHMS, SLDAConfig, combine, partition
from repro_torch.core import parallel as ppar
from repro_torch.core.plan import build_plan
from repro_torch.core.types import _concat_corpora
from test_torch_parallel import _ref_predict_draws, _ref_train_draws

CFG = dict(n_topics=8, vocab_size=150, n_iters=12, rho=0.25,
           n_pred_burnin=8, n_pred_samples=6, label_type="binary")
SEEDS = (7, 8, 9)
M = 4


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


def _acc(yhat, y):
    return float(((np.asarray(yhat) > 0.5) == (np.asarray(y) > 0.5)).mean())


def _np_binary_corpus(seed, n_docs, vocab, n_topics, max_len):
    """A corpus drawn by numpy from the sLDA generative process, as the
    generators of both packages draw it: φ_t ~ Dir(0.01), θ_d ~ Dir(0.1),
    z ~ θ_d, w ~ φ_z, log-normal lengths, the response ηᵀz̄ + noise
    thresholded at its median (Figure 7's binary labels)."""
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(vocab, 0.01), n_topics)
    theta = rng.dirichlet(np.full(n_topics, 0.1), n_docs)
    z = np.stack([rng.choice(n_topics, max_len, p=t) for t in theta])
    tokens = np.stack([[rng.choice(vocab, p=phi[k]) for k in row]
                       for row in z]).astype(np.int32)
    lens = np.clip(np.round(rng.lognormal(np.log(max_len / 4), 0.75,
                                          n_docs)), 4, max_len)
    mask = (np.arange(max_len) < lens[:, None]).astype(np.float32)
    zbar = np.stack([np.bincount(r[m > 0], minlength=n_topics)
                     for r, m in zip(z, mask)]) / lens[:, None]
    y = zbar @ (rng.normal(size=n_topics) * 2.0) \
        + 0.5 * rng.normal(size=n_docs)
    return tokens, mask, (y > np.median(y)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus_pair():
    """A binary-label corpus with log-normal lengths (Figure 7's kind at a
    small size), in both packages."""
    tokens, mask, y = _np_binary_corpus(0, 600, 150, 8, 40)
    j = lambda sl: JCorpus(*(jnp.asarray(a[sl]) for a in (tokens, mask, y)))
    p = lambda sl: corpus_from_numpy(tokens[sl], mask[sl], y[sl],
                                     device="cpu")
    tr, te = slice(0, 400), slice(400, None)
    return (j(tr), j(te)), (p(tr), p(te))


def _train(keys, shards, cfg):
    """The port's chains trained under the reference's draws for `keys`."""
    m, d, n = shards.tokens.shape
    z, us = _ref_train_draws(keys, d, n, cfg.n_topics, cfg.n_iters)
    return build_plan(shards, cfg).train(_t(z), (_t(u) for u in us))


def _predict(keys, models, corpus, cfg):
    z0, seeds = _ref_predict_draws(keys, corpus.n_docs, corpus.max_len,
                                   cfg.n_topics)
    return build_plan(corpus, cfg).predict(_t(z0), _t(seeds), models)


def _port_with_reference_draws(name, key, train, test, cfg):
    """One algorithm of the port, its draws those of the reference's
    `run_*(key, ...)` (its key tree: repro/core/parallel.py)."""
    if name == "nonparallel":
        k1, k2 = jax.random.split(key)
        _, model = _train(k1[None], partition(train, 1), cfg)
        return _predict(k2[None], model, test, cfg)[0]
    if name == "naive":
        k1, _, k3 = jax.random.split(key, 3)
        shards = partition(train, M)
        states, _ = _train(jax.random.split(k1, M), shards, cfg)
        model = ppar.pooled_model(states, shards, cfg)
        return _predict(k3[None], model, test, cfg)[0]
    k1, k2 = jax.random.split(key, 3 if name == "weighted" else 2)[:2]
    _, models = _train(jax.random.split(k1, M), partition(train, M), cfg)
    if name == "simple":
        return combine.simple_average(
            _predict(jax.random.split(k2, M), models, test, cfg))
    yhat = _predict(jax.random.split(k2, M), models,
                    _concat_corpora(test, train), cfg)
    return ppar._combine_weighted(yhat[:, :test.n_docs],
                                  yhat[:, test.n_docs:], train.y, cfg, None)


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_algorithm_with_reference_draws_gives_reference_yhat(corpus_pair,
                                                             name):
    """Each algorithm, binary labels, under the reference's draws: ŷ
    within 1e-4 of the reference's, and the same test accuracy."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    j_cfg, p_cfg = JConfig(**CFG), SLDAConfig(**CFG)
    key = jax.random.PRNGKey(SEEDS[0])
    fn = jpar.ALGORITHMS[name]
    args = (key, j_train, j_test, j_cfg) + (() if name == "nonparallel"
                                            else (M,))
    j_yhat = np.asarray(fn(*args))
    p_yhat = _port_with_reference_draws(name, key, p_train, p_test,
                                        p_cfg).numpy()
    print(f"{name}: max |ŷ_port - ŷ_ref| "
          f"{np.abs(p_yhat - j_yhat).max():.2e}")
    np.testing.assert_allclose(p_yhat, j_yhat, rtol=1e-4, atol=1e-4)
    assert _acc(p_yhat, p_test.y) == _acc(j_yhat, j_test.y)


def test_export_train_acc_and_weights_match_reference(corpus_pair):
    """`_export`'s training accuracy under the reference's draws equals
    the reference's: the same count of training documents right in every
    chain (the two means may round that count's share 1 ulp apart); and
    `_combine_weighted` weights by accuracy as the reference does (within
    1e-6 on the same predictions)."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=4)
    key = jax.random.PRNGKey(12)
    keys = jax.random.split(key, M)
    _, j_models = jax.jit(jpar.train_chains_keyed, static_argnums=(2,))(
        keys, j_partition(j_train, M), JConfig(**kw))
    _, p_models = _train(keys, partition(p_train, M), SLDAConfig(**kw))
    d = p_train.n_docs // M
    np.testing.assert_array_equal(
        np.round(p_models.train_acc.numpy() * d),
        np.round(np.asarray(j_models.train_acc) * d))
    np.testing.assert_allclose(p_models.train_acc.numpy(),
                               np.asarray(j_models.train_acc), rtol=1e-6)
    rng = np.random.default_rng(0)
    te = rng.random((M, 30)).astype(np.float32)
    tr = rng.random((M, 50)).astype(np.float32)
    y = (rng.random(50) > 0.5).astype(np.float32)
    want = jpar._combine_weighted(jnp.asarray(te), jnp.asarray(tr),
                                  jnp.asarray(y), JConfig(**kw), None)
    got = ppar._combine_weighted(_t(te), _t(tr), _t(y), SLDAConfig(**kw),
                                 None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def accuracies(corpus_pair):
    """3-seed test accuracies: the port's Naive, Simple and Weighted, and
    the reference's Simple and Weighted, on the same corpus."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    port = {name: [] for name in ("naive", "simple", "weighted")}
    for s in SEEDS:
        for name in port:
            yhat = ALGORITHMS[name](s, p_train, p_test, SLDAConfig(**CFG), M,
                                    device="cpu")
            port[name].append(_acc(yhat, p_test.y))
    # the reference's orchestrators as they are (their inner jits are
    # shared with the runs under the reference's draws above)
    ref = {"simple": [], "weighted": []}
    for name in ref:
        for s in SEEDS:
            y = jpar.ALGORITHMS[name](jax.random.PRNGKey(s), j_train, j_test,
                                      JConfig(**CFG), M)
            ref[name].append(_acc(y, j_test.y))
    print({k: np.round(v, 4).tolist() for k, v in port.items()}, ref)
    return ({k: float(np.mean(v)) for k, v in port.items()},
            {k: float(np.mean(v)) for k, v in ref.items()})


@pytest.mark.parametrize("name", ["simple", "weighted"])
def test_port_accuracy_within_5_points_of_reference(accuracies, name):
    port, ref = accuracies
    assert abs(port[name] - ref[name]) <= 0.05


def test_port_naive_combination_is_below_simple(accuracies):
    port, _ = accuracies
    assert port["naive"] < port["simple"]


def test_fig7_configuration_is_the_reference_harness_at_scale_1(
        monkeypatch):
    """`repro_torch.fig7_imdb`'s constants are those the reference's
    `benchmarks/fig7_imdb.run(scale=1.0)` builds (read off its calls,
    stopped before it draws a corpus)."""
    import benchmarks.fig7_imdb as harness
    from repro_torch import fig7_imdb
    seen = {}

    class Stop(Exception):
        pass

    def fake_make(key, n_docs, vocab, n_topics, doc_len, **kw):
        seen.update(n_docs=n_docs, vocab=vocab, n_topics=n_topics,
                    doc_len=doc_len, **kw)
        return jnp.zeros(()), None

    def fake_split(corpus, n_train):
        seen["n_train"] = n_train
        raise Stop

    real_cfg = harness.SLDAConfig
    monkeypatch.setattr(harness, "SLDAConfig",
                        lambda **kw: seen.setdefault("cfg", real_cfg(**kw)))
    monkeypatch.setattr(harness, "make_slda_corpus", fake_make)
    monkeypatch.setattr(harness, "train_test_split", fake_split)
    with pytest.raises(Stop):
        harness.run(scale=1.0)
    assert (fig7_imdb.N_DOCS, fig7_imdb.VOCAB, fig7_imdb.N_TOPICS,
            fig7_imdb.DOC_LEN, fig7_imdb.N_TRAIN, fig7_imdb.M) == (
        seen["n_docs"], seen["vocab"], seen["n_topics"], seen["doc_len"],
        seen["n_train"], harness.M) == (25000, 16000, 16, 150, 20000, 4)
    assert seen["label_type"] == "binary" and seen["rho"] == 0.25
    assert seen["doc_len_dist"] == "lognormal"
    ref_cfg, cfg = seen["cfg"], fig7_imdb.CFG
    for f in ("n_topics", "vocab_size", "rho", "n_iters", "label_type",
              "n_pred_burnin", "n_pred_samples", "alpha", "beta"):
        assert getattr(cfg, f) == getattr(ref_cfg, f), f
