"""The port's EM loop, prediction, combine rules and the paper's four
algorithms against the reference, on the same numpy-made or converted
inputs, and the reference's own random draws where the plan takes them."""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SLDAConfig as JConfig
from repro.core import combine as jcombine
from repro.core import run_simple_average as j_simple
from repro.core import run_weighted_average as j_weighted
from repro.core.plan import build_plan as j_build_plan
from repro.core.regression import solve_eta as j_solve_eta
from repro.core.regression import solve_eta_ols as j_solve_eta_ols
from repro.core.types import partition as j_partition
from repro.data import make_slda_corpus as j_make
from repro.data import train_test_split as j_split
from repro_torch.convert import (corpus_from_numpy, model_from_numpy,
                                 state_from_numpy)
from repro_torch.core import (ALGORITHMS, SLDAConfig, combine, partition,
                              solve_eta, solve_eta_ols)
from repro_torch.core.plan import build_plan

CFG = dict(n_topics=8, vocab_size=200, n_iters=25, rho=0.25)
SEEDS = (7, 8, 9)


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


def _to_port(c):
    return corpus_from_numpy(c.tokens, c.mask, c.y, device="cpu")


@pytest.fixture(scope="module")
def corpus_pair():
    """tests/test_system.py's corpus, drawn by the reference, converted."""
    make = jax.jit(j_make, static_argnums=(1, 2, 3, 4),
                   static_argnames=("rho",))
    corpus, _ = make(jax.random.PRNGKey(0), 400, 200, 8, 50, rho=0.25)
    train, test = j_split(corpus, 320)
    return (train, test), (_to_port(train), _to_port(test))


# ---------------------------------------------------------- regression

def _zbar_y(seed, lead=()):
    rng = np.random.default_rng(seed)
    zb = rng.dirichlet(np.full(8, 0.3), lead + (300,)).astype(np.float32)
    y = (zb @ rng.normal(size=8) * 2 + rng.normal(size=lead + (300,)) * 0.5)
    return zb, y.astype(np.float32)


def test_solve_eta_matches_reference():
    cfg = SLDAConfig(n_topics=8, rho=0.25, mu=0.3)
    zb, y = _zbar_y(0)
    want = np.asarray(j_solve_eta(jnp.asarray(zb), jnp.asarray(y),
                                  JConfig(n_topics=8, rho=0.25, mu=0.3)))
    got = solve_eta(_t(zb), _t(y), cfg).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    want = np.asarray(j_solve_eta_ols(jnp.asarray(zb), jnp.asarray(y)))
    got = solve_eta_ols(_t(zb), _t(y)).numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_solve_eta_batches_chains():
    cfg = SLDAConfig(n_topics=8, rho=0.25)
    zb, y = _zbar_y(1, (3,))
    got = solve_eta(_t(zb), _t(y), cfg)
    for c in range(3):
        torch.testing.assert_close(got[c], solve_eta(_t(zb[c]), _t(y[c]),
                                                     cfg))


# ------------------------------------------------------------- combine

@pytest.fixture
def yhat():
    rng = np.random.default_rng(2)
    return rng.normal(size=(4, 9)).astype(np.float32), \
        rng.uniform(0.1, 2.0, 4).astype(np.float32)


@pytest.mark.parametrize("alive", [None, [1, 0, 1, 1], [0, 0, 1, 0]])
def test_combine_rules_match_reference(yhat, alive):
    y, mse = yhat
    a_j = None if alive is None else jnp.asarray(alive, jnp.float32)
    a_p = None if alive is None else torch.tensor(alive, dtype=torch.float32)
    pairs = [
        (jcombine.simple_average(jnp.asarray(y), alive=a_j),
         combine.simple_average(_t(y), alive=a_p)),
        (jcombine.weighted_average(jnp.asarray(y), train_mse=jnp.asarray(mse),
                                   alive=a_j),
         combine.weighted_average(_t(y), train_mse=_t(mse), alive=a_p)),
        (jcombine.weighted_average(jnp.asarray(y), train_acc=jnp.asarray(mse),
                                   alive=a_j),
         combine.weighted_average(_t(y), train_acc=_t(mse), alive=a_p)),
        (jcombine.median(jnp.asarray(y), alive=a_j),
         combine.median(_t(y), alive=a_p)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_dead_chain_is_dropped_exactly_even_if_poisoned(yhat):
    y, mse = yhat
    y_bad = y.copy()
    y_bad[1] = np.nan
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0])
    for rule in (combine.simple_average, combine.median):
        got = rule(_t(y_bad), alive=alive)
        assert torch.equal(got, rule(_t(y[[0, 2, 3]])))
    got = combine.weighted_average(_t(y_bad), train_mse=_t(mse), alive=alive)
    want = combine.weighted_average(_t(y[[0, 2, 3]]),
                                    train_mse=_t(mse[[0, 2, 3]]))
    torch.testing.assert_close(got, want)


def test_all_dead_mask_warns_and_falls_back(yhat):
    y, mse = yhat
    dead = torch.zeros(4)
    assert combine.all_dead(dead) and not combine.all_dead(None)
    for rule, kw in ((combine.simple_average, {}), (combine.median, {}),
                     (combine.weighted_average, {"train_mse": _t(mse)})):
        with pytest.warns(RuntimeWarning, match="all-dead"):
            got = rule(_t(y), alive=dead, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert torch.equal(got, rule(_t(y), **kw))
    with pytest.raises(ValueError):
        combine.weighted_average(_t(y))


# --------------------------------- the plan under the reference's draws

@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _ref_train_draws(keys, d, n, t, n_iters):
    """The initial topics and per-sweep uniforms the reference's
    `ExecutionPlan.train(keys)` draws (plan.py: init_states, train_em)."""
    ks = jax.vmap(jax.random.split)(keys)
    z = jax.vmap(lambda k: jax.random.randint(k, (d, n), 0, t, jnp.int32))(
        ks[:, 0])
    sk = jnp.moveaxis(jax.vmap(lambda k: jax.random.split(k, n_iters))(
        ks[:, 1]), 0, 1)
    return z, [jax.vmap(lambda k: jax.random.uniform(k, (d, n)))(sk[i])
               for i in range(n_iters)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _ref_predict_draws(keys, d, n, t):
    """z0 and per-document seeds of the reference's `predict_zbar(keys)`."""
    ks = jax.vmap(jax.random.split)(keys)
    z0 = jax.vmap(lambda k: jax.random.randint(k, (d, n), 0, t, jnp.int32))(
        ks[:, 0])
    seeds = jax.vmap(lambda k: jax.random.randint(
        k, (d,), 0, jnp.iinfo(jnp.int32).max, jnp.int32))(ks[:, 1])
    return z0, seeds


def test_train_with_reference_draws_matches_reference(corpus_pair):
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=4, count_rebuild_every=3)
    j_shards, p_shards = j_partition(j_train, 4), partition(p_train, 4)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    j_state, j_models = jax.jit(
        lambda k, c: j_build_plan(c, JConfig(**kw)).train(k))(keys, j_shards)
    z, us = _ref_train_draws(keys, 80, 50, 8, 4)
    p_state, p_models = build_plan(p_shards, SLDAConfig(**kw)).train(
        _t(z), (_t(u) for u in us))
    mask = np.asarray(j_shards.mask)
    rate = float(((p_state.z.numpy() != np.asarray(j_state.z)) * mask).sum()
                 / mask.sum())
    print(f"4 EM iterations under the reference's draws: "
          f"draw mismatch {rate:.2e}")
    assert rate <= 1e-3
    # counts stay exactly consistent with the port's own assignments
    from repro_torch.core import counts_from_assignments
    ndt, ntw, nt = counts_from_assignments(p_shards.tokens, p_shards.mask,
                                           p_state.z, 8, 200)
    assert torch.equal(ndt, p_state.ndt) and torch.equal(ntw, p_state.ntw)
    assert torch.equal(nt, p_state.nt)
    np.testing.assert_allclose(p_models.eta.numpy(),
                               np.asarray(j_models.eta), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_models.phi.numpy(),
                               np.asarray(j_models.phi), rtol=1e-3, atol=1e-6)


def test_predict_with_reference_draws_matches_reference(corpus_pair):
    (j_train, j_test), (_, p_test) = corpus_pair
    cfg = JConfig(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    _, j_models = jax.jit(lambda k, c: j_build_plan(c, cfg).train(k))(
        keys, j_partition(j_train, 4))
    j_yhat = jax.jit(lambda k, c, m: j_build_plan(c, cfg).predict(k, m))(
        keys, j_test, j_models)
    z0, seeds = _ref_predict_draws(keys, 80, 50, 8)
    models = model_from_numpy(j_models.phi, j_models.eta, j_models.train_mse,
                              j_models.train_acc, device="cpu")
    p_yhat = build_plan(p_test, SLDAConfig(**CFG)).predict(_t(z0), _t(seeds),
                                                          models)
    np.testing.assert_allclose(p_yhat.numpy(), np.asarray(j_yhat),
                               rtol=1e-4, atol=1e-4)


def test_from_numpy_carries_fields_and_dtypes():
    rng = np.random.default_rng(4)
    z = rng.integers(0, 8, (6, 5)).astype(np.int32)
    f = lambda *shape: rng.random(shape).astype(np.float32)
    st = state_from_numpy(z, f(6, 8), f(8, 20), f(8), f(8), device="cpu")
    assert st.z.dtype == torch.int32 and np.array_equal(st.z.numpy(), z)
    assert st.ntw.dtype == torch.float32 and tuple(st.ntw.shape) == (8, 20)
    m = model_from_numpy(f(2, 8, 20), f(2, 8), f(2), f(2), device="cpu")
    assert tuple(m.phi.shape) == (2, 8, 20) and m.eta.dtype == torch.float32


def test_single_chain_sweep_matches_reference(corpus_pair):
    """gibbs.init_state / sweep: one sweep under the reference's uniforms,
    with both count-refresh forms; the counts stay those of the port's z."""
    from repro.core import gibbs as j_gibbs
    from repro_torch.core import counts_from_assignments, gibbs
    (j_train, _), (p_train, _) = corpus_pair
    cfg_j, cfg_p = JConfig(**CFG), SLDAConfig(**CFG)
    j_state = j_gibbs.init_state(jax.random.PRNGKey(2), j_train, cfg_j)
    j_state.eta = j_state.eta + 0.3
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, j_train.tokens.shape)  # what sweep draws
    j_sweep = jax.jit(j_gibbs.sweep, static_argnums=(3,),
                      static_argnames=("exact_rebuild",))
    st = state_from_numpy(j_state.z, j_state.ndt, j_state.ntw, j_state.nt,
                          j_state.eta, device="cpu")
    mask = np.asarray(j_train.mask)
    for rebuild in (True, False):
        want = j_sweep(key, j_train, j_state, cfg_j, exact_rebuild=rebuild)
        got = gibbs.sweep(_t(u), p_train, st, cfg_p, exact_rebuild=rebuild)
        rate = float(((got.z.numpy() != np.asarray(want.z)) * mask).sum()
                     / mask.sum())
        assert rate <= 1e-3
        counts = counts_from_assignments(p_train.tokens, p_train.mask,
                                         got.z, 8, 200)
        for f, c in zip(("ndt", "ntw", "nt"), counts):
            assert torch.equal(getattr(got, f), c)
    st0 = gibbs.init_state(torch.Generator().manual_seed(0), p_train, cfg_p)
    assert float(st0.ndt.sum()) == float(p_train.mask.sum())
    assert torch.equal(st0.eta, torch.zeros(8))


def test_train_chain_and_predict_learn_signal(corpus_pair):
    """The single-chain API, as tests/test_system.py's first test."""
    from repro_torch.core import predict, train_chain, zbar
    _, (p_train, p_test) = corpus_pair
    cfg = SLDAConfig(**CFG)
    state, model = train_chain(1, p_train, cfg, device="cpu")
    assert tuple(model.phi.shape) == (8, 200)
    torch.testing.assert_close(model.phi.sum(-1), torch.ones(8))
    assert zbar(state, p_train).sum(-1).allclose(
        (p_train.mask.sum(-1) > 0).to(torch.float32))
    y = predict(2, model, p_test, cfg, device="cpu")
    mse = float(((y - p_test.y) ** 2).mean())
    assert mse < 0.6 * float(p_test.y.var(unbiased=False))


# ----------------------------------------------- the paper's algorithms

@pytest.fixture(scope="module")
def mses(corpus_pair):
    """3-seed test MSEs: every algorithm of the port, and the reference's
    simple and weighted averages, on the same (reference-drawn) corpus."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    cfg_p, cfg_j = SLDAConfig(**CFG), JConfig(**CFG)
    port = {name: [] for name in ALGORITHMS}
    for s in SEEDS:
        for name, fn in ALGORITHMS.items():
            args = (s, p_train, p_test, cfg_p) + (
                () if name == "nonparallel" else (4,))
            y = fn(*args, device="cpu")
            port[name].append(float(((y - p_test.y) ** 2).mean()))
    ref = {"simple": [], "weighted": []}
    for name, fn in (("simple", j_simple), ("weighted", j_weighted)):
        jfn = jax.jit(fn, static_argnums=(3, 4))
        for s in SEEDS:
            y = jfn(jax.random.PRNGKey(s), j_train, j_test, cfg_j, 4)
            ref[name].append(float(jnp.mean((y - j_test.y) ** 2)))
    print({k: np.round(v, 4).tolist() for k, v in port.items()}, ref)
    return ({k: float(np.mean(v)) for k, v in port.items()},
            {k: float(np.mean(v)) for k, v in ref.items()},
            float(p_test.y.var(unbiased=False)))



def test_port_learns_signal(mses):
    port, _, var_y = mses
    for name in ("nonparallel", "simple", "weighted"):
        assert port[name] < 0.6 * var_y


def test_port_naive_combination_suffers_quasi_ergodicity(mses):
    port, _, _ = mses
    assert port["naive"] > 2.0 * port["simple"]
    assert port["naive"] > 2.0 * port["nonparallel"]


def test_port_prediction_combination_matches_nonparallel(mses):
    port, _, _ = mses
    assert port["simple"] < 1.35 * port["nonparallel"]
    assert port["weighted"] < 1.35 * port["nonparallel"]
    assert port["weighted"] < 1.25 * port["simple"]


@pytest.mark.parametrize("name", ["simple", "weighted"])
def test_port_mse_within_15_percent_of_reference(mses, name):
    port, ref, _ = mses
    assert abs(port[name] - ref[name]) <= 0.15 * ref[name]
