"""The port's multi-process chain runner (`repro_torch.launch.
slda_parallel`) and its collective counter (`launch.collectives`).

Ranks run as spawned processes on the CPU under gloo, world sizes 2 and
4 with 1 or 2 chains a rank, joined by a `file://` rendezvous under the
test's temporary directory (fixed TCP ports would collide across test
workers), each group with a timeout.  Each rank's gathered per-chain
predictions must be bit-equal to one process running all M chains with
the same seed (`train_chains` on the M shards, `predict_chains`), ŷ the
combine of those rows; the training phase must count no collective and
everything after it exactly the one gather.  A planted `all_reduce` is
counted.  The rules, `alive`, and a NaN chain's auto-quarantine are held
bit for bit against the survivors' combine; 3 length buckets bit for bit
against padded at spl 1 (the reference's `tests/test_ragged.py`).  Last,
one rank with all M chains under the reference's draws against the
reference's `parallel_slda_shard_map` on a one-device mesh: ŷ within
1e-4, as the Figure 7 tests hold the algorithms.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.core import SLDAConfig as JConfig
from repro.data import make_slda_corpus as j_make
from repro.data import train_test_split as j_split
from repro.launch.slda_parallel import parallel_slda_shard_map
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import (SLDAConfig, combine, predict_chains,
                              train_chains)
from repro_torch.core.parallel import _shards
from repro_torch.core.regression import solve_eta
from repro_torch.launch.collectives import CollectiveStats, count_collectives
from repro_torch.mathutil import chain_matvec
from repro_torch.launch.slda_parallel import (RankDraws, init_group,
                                              parallel_slda, rank_runs,
                                              run_ranks)

from test_torch_parallel import _ref_predict_draws, _ref_train_draws

SEED = 3
CFG = SLDAConfig(n_topics=4, vocab_size=32, n_iters=6, n_pred_burnin=2,
                 n_pred_samples=2)
# the reference's ragged runner test (tests/test_ragged.py)
RAGGED = SLDAConfig(n_topics=8, vocab_size=80, n_iters=2, rho=0.25,
                    n_pred_burnin=1, n_pred_samples=1)
TIMEOUT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(c):
    return corpus_from_numpy(c.tokens, c.mask, c.y, device="cpu")


@pytest.fixture(scope="module")
def ref_corpus():
    c, _ = j_make(jax.random.PRNGKey(0), 48, 32, 4, 8)
    return j_split(c, 32)


@pytest.fixture(scope="module")
def corpus(ref_corpus):
    return tuple(_port(x) for x in ref_corpus)


@pytest.fixture(scope="module")
def ragged():
    c, _ = j_make(jax.random.PRNGKey(22), 40, 80, 8, 20, rho=0.25,
                  doc_len_dist="lognormal")
    return tuple(_port(x) for x in j_split(c, 32))


def _runs(world, ragged):
    """Every run of one world size; each result is read by name."""
    tr, te = ragged
    runs = {
        "cpd1": dict(cfg=CFG, chains_per_device=1),
        "cpd2": dict(cfg=CFG, chains_per_device=2),
        "weighted": dict(cfg=CFG, chains_per_device=2, rule="weighted"),
        "median": dict(cfg=CFG, chains_per_device=2, rule="median"),
        "spl2_sparse": dict(cfg=dataclasses.replace(
            CFG, sweeps_per_launch=2, sampler_mode="sparse",
            sparse_topic_cap=2), chains_per_device=2),
        "alive": dict(cfg=CFG, chains_per_device=2,
                      alive=torch.tensor([1.0, 0.0] * world)),
        "poison_simple": dict(cfg=CFG, chains_per_device=2,
                              poison=(1, "nan_eta")),
        "poison_weighted": dict(cfg=CFG, chains_per_device=2,
                                rule="weighted", poison=(2, "nan_eta")),
        "padded": dict(cfg=RAGGED, chains_per_device=1, train=tr, test=te),
        "buckets": dict(cfg=dataclasses.replace(
            RAGGED, length_buckets=3, bucket_overhead_docs=0.0),
            chains_per_device=1, train=tr, test=te),
    }
    return runs


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranked(request, corpus, ragged):
    """(world, {run name: [rank 0's result, rank 1's, ...]}, start-up
    seconds by rank): every run of `_runs` in `world` spawned ranks."""
    world = request.param
    runs = _runs(world, ragged)
    names = list(runs)
    train, test = corpus
    res = run_ranks(world, rank_runs, dict(seed=SEED, train=train,
                                           test=test,
                                           runs=list(runs.values()),
                                           device="cpu"),
                    timeout_s=TIMEOUT_S)
    by_name = {n: [r[0][i] for r in res] for i, n in enumerate(names)}
    return world, by_name, [r[1] for r in res]


def _single(train, test, cfg, m):
    """One process, all M chains: (per-chain ŷ [M, D_test], models)."""
    _, models = train_chains(SEED, _shards(train, m, cfg, "cpu"), cfg,
                             device="cpu")
    return predict_chains(SEED, models, test, cfg, device="cpu"), models


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def _check_chain_batches(world, by_name, startup, corpus):
    """cpd 1 and 2, dense and fused sparse: every rank's gathered rows are
    the single process's, ŷ its combine."""
    for name, cpd in (("cpd1", 1), ("cpd2", 2), ("spl2_sparse", 2)):
        cfg = _runs(world, (None, None))[name]["cfg"]
        y, _ = _single(*corpus, cfg, world * cpd)
        want = combine.simple_average(y).numpy()
        for rank, r in enumerate(by_name[name]):
            rep = r["report"]
            assert rep["world"] == world and rep["rank"] == rank
            assert rep["chain_ids"] == list(range(rank * cpd,
                                                  (rank + 1) * cpd))
            assert rep["backend"] == "gloo"
            assert _eq(rep["yhat_chains"], y.numpy()), (name, rank)
            assert _eq(r["yhat"], want), (name, rank)
            assert rep["n_quarantined"] == 0
            assert set(rep["ms"]) == {"train", "predict", "gather",
                                      "gather_host"}
    assert all(s > 0 for s in startup)


def _check_collectives(by_name):
    """No collective in training; exactly the one gather after it."""
    for name, results in by_name.items():
        for r in results:
            coll = r["report"]["collectives"]
            assert coll["train"]["count"] == 0, name
            assert coll["train"]["bytes_total"] == 0, name
            after = coll["after_train"]
            assert after["count"] == 1, name
            (kind, calls), = after["calls_by_kind"].items()
            assert kind in ("all_gather_single", "all_gather_into_tensor")
            assert calls == 1
            m, d = r["report"]["yhat_chains"].shape
            assert after["bytes_total"] == m * (d + 2) * 4, name


def _check_rules_and_faults(world, by_name, corpus):
    """Weighted and median, `alive`, and a NaN chain auto-quarantined:
    each the single process's combine bit for bit."""
    y, models = _single(*corpus, CFG, 2 * world)
    rules = {"weighted": combine.weighted_average(
        y, train_mse=models.train_mse), "median": combine.median(y)}
    for rule, want in rules.items():
        for r in by_name[rule]:
            assert _eq(r["yhat"], want.numpy()), rule
            assert _eq(r["report"]["train_stats"][:, 0],
                       models.train_mse.numpy())
    alive = torch.tensor([1.0, 0.0] * world)
    for r in by_name["alive"]:
        assert _eq(r["yhat"], combine.simple_average(y, alive=alive))
        assert r["report"]["n_quarantined"] == world
    for name, chain in (("poison_simple", 1), ("poison_weighted", 2)):
        alive = torch.ones(2 * world)
        alive[chain] = 0.0
        want = (combine.simple_average(y, alive=alive)
                if name == "poison_simple" else combine.weighted_average(
                    y, train_mse=models.train_mse, alive=alive))
        keep = np.arange(2 * world) != chain
        for r in by_name[name]:
            rep = r["report"]
            assert rep["n_quarantined"] == 1 and _eq(rep["alive"], alive)
            assert np.isnan(rep["yhat_chains"][chain]).all()
            assert _eq(rep["yhat_chains"][keep], y.numpy()[keep])
            assert np.isfinite(r["yhat"]).all()
            assert _eq(r["yhat"], want.numpy()), name


def _check_buckets(world, by_name, ragged):
    """The reference's `test_shard_map_runner_bucketed_routing`: 3 length
    buckets, the schedule built over all M shards, bit for bit the padded
    run at spl 1; and both are the single process's."""
    y, _ = _single(*ragged, RAGGED, world)
    for pad, bkt in zip(by_name["padded"], by_name["buckets"]):
        assert _eq(bkt["yhat"], pad["yhat"])
        assert _eq(bkt["report"]["yhat_chains"],
                   pad["report"]["yhat_chains"])
        assert _eq(pad["report"]["yhat_chains"], y.numpy())


def test_ranks_match_one_process(ranked, corpus, ragged):
    """Every run of one world size (one spawn of its ranks: the checks
    share it, so that test workers do not spawn it again)."""
    world, by_name, startup = ranked
    _check_chain_batches(world, by_name, startup, corpus)
    _check_collectives(by_name)
    _check_rules_and_faults(world, by_name, corpus)
    _check_buckets(world, by_name, ragged)


def test_a_chains_numbers_do_not_depend_on_its_batch():
    """ROADMAP C7: at D = 750, T = 16 (the slice's shard) a batched
    [M, T, D] @ [M, D, 1] product differed in the last bits between M = 1
    and M = 4 on the CPU, so a rank of one chain drew another ensemble
    than one process of four.  The η solve now runs in groups of
    `CHAIN_GROUP` chains and `zb @ η` chain by chain: any block of chains
    gets the bits the whole batch gets."""
    g = torch.Generator().manual_seed(0)
    zbar = torch.rand((8, 750, 16), generator=g)
    zbar = zbar / zbar.sum(-1, keepdim=True)
    y = torch.randn((8, 750), generator=g)
    eta = torch.randn((8, 16), generator=g)
    cfg = SLDAConfig(n_topics=16, rho=0.25)
    whole = solve_eta(zbar, y, cfg)
    for k in (1, 2, 3, 4, 5):
        for c in range(8 - k + 1):
            assert torch.equal(solve_eta(zbar[c:c + k], y[c:c + k], cfg),
                               whole[c:c + k]), (c, k)
    alone = [chain_matvec(zbar[c:c + 1], eta[c:c + 1]) for c in range(8)]
    assert torch.equal(chain_matvec(zbar, eta), torch.cat(alone))
    # the flat (one-chain) forms are the plain products
    assert torch.equal(chain_matvec(zbar[0], eta[0]), zbar[0] @ eta[0])


# ---------------------------------------------- one rank, in this process

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo group of one rank in this process (a `file://` rendezvous
    under a temporary directory, with a timeout)."""
    store = tmp_path_factory.mktemp("rendezvous") / "store"
    init_group("gloo", 0, 1, f"file://{store}", timeout_s=TIMEOUT_S)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_counter_catches_a_planted_all_reduce(one_rank):
    def chain_fn(x):
        x = x * 2
        dist.all_reduce(x)           # the collective a chain must not make
        return x

    original = dist.all_reduce
    x = torch.ones(5, dtype=torch.float32)
    with count_collectives() as outer:
        with count_collectives() as inner:
            chain_fn(x)
        dist.barrier()
    assert inner.count == 1 and inner.calls_by_kind == {"all_reduce": 1}
    assert inner.by_kind == {"all_reduce": 40.0}
    assert inner.bytes_total == 40.0
    assert outer.count == 2 and outer.calls_by_kind == {"all_reduce": 1,
                                                        "barrier": 1}
    assert dist.all_reduce is original      # unpatched after the block
    chain_fn(x)
    assert inner.count == 1 and outer.count == 2
    assert isinstance(inner, CollectiveStats)


def test_one_rank_runs_every_chain(one_rank, corpus):
    y, _ = _single(*corpus, CFG, 4)
    got, rep = parallel_slda(SEED, *corpus, CFG, chains_per_device=4,
                             device="cpu", return_report=True)
    assert torch.equal(rep["yhat_chains"], y)
    assert torch.equal(got, combine.simple_average(y))
    assert rep["collectives"]["train"].count == 0
    with pytest.raises(ValueError, match="exactly one"):
        parallel_slda(None, *corpus, CFG, device="cpu")


def test_reference_parity_under_the_reference_draws(one_rank, ref_corpus,
                                                    corpus):
    """The reference's runner on a one-device mesh, chains_per_device M,
    against one rank with every chain under the reference's draws (its
    fold_in(key, chain) keys, split into train and predict keys), Simple
    and Weighted Average."""
    m = 4
    key = jax.random.PRNGKey(11)
    j_train, j_test = ref_corpus
    jcfg = JConfig(n_topics=4, vocab_size=32, n_iters=6, n_pred_burnin=2,
                   n_pred_samples=2)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jax.jit(lambda k: [parallel_slda_shard_map(
        k, j_train, j_test, jcfg, mesh, rule=rule, chains_per_device=m)
        for rule in ("simple", "weighted")])(key)
    keys = jax.vmap(lambda c: jax.random.fold_in(key, c))(
        jax.numpy.arange(m))
    ks = jax.vmap(jax.random.split)(keys)

    def t(x):
        return torch.from_numpy(np.array(x))

    def train_draws(ids, d, n):
        z, us = _ref_train_draws(ks[:, 0], d, n, CFG.n_topics, CFG.n_iters)
        return t(z), (t(u) for u in us)

    def predict_draws(ids, d, n):
        z0, seeds = _ref_predict_draws(ks[:, 1], d, n, CFG.n_topics)
        return t(z0), t(seeds)

    draws = RankDraws(train=train_draws, predict=predict_draws)
    for rule, w in zip(("simple", "weighted"), want):
        got = parallel_slda(None, *corpus, CFG, rule=rule,
                            chains_per_device=m, device="cpu", draws=draws)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
