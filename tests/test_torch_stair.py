"""The staircase executors, the plan's CPU route over several length
buckets, against the reference's `jnp` route and the port's blocks
executor: the segment plumbing bit for bit, stair prediction bit for bit
the blocks and padded runs per document, stair training at one sweep a
launch bit for bit the blocks route and at four under the reference's
draws within the mismatch rule, and the executor each plan picks."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SLDAConfig as JConfig
from repro.core import plan as jplan
from repro.core import types as jtypes
from repro_torch.convert import model_from_numpy
from repro_torch.core import (SLDAConfig, bucket_corpus, build_schedule,
                              counts_from_assignments, partition, rng)
from repro_torch.core import types as ptypes
from repro_torch.core.plan import _word_major, build_plan
from test_torch_parallel import _ref_predict_draws
from test_torch_ragged import _lengths_corpus
from test_torch_train import _ref_fused_draws

MISMATCH_MAX = 1e-3
CFG = dict(n_topics=6, vocab_size=60, rho=0.25, n_pred_burnin=2,
           n_pred_samples=2, count_rebuild_every=2, sparse_topic_cap=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def corpus_pair():
    """128 training documents and 32 test ones of log-normal lengths (to
    32 tokens), numpy-made, in both packages."""
    (j_tr, p_tr), (j_te, p_te) = (_lengths_corpus(s, (d,), n=32)
                                  for s, d in ((30, 128), (31, 32)))
    return (j_tr, j_te), (p_tr, p_te)


def _reference_schedule(bc):
    """The reference's `BucketedCorpus` of the port's schedule, tensor for
    tensor (`test_torch_ragged.py` holds the two packages' `bucket_corpus`
    equal; the reference's takes a second or more eagerly)."""
    return jtypes.BucketedCorpus(
        buckets=tuple(jtypes.Corpus(*(jnp.asarray(getattr(b, f).numpy())
                                      for f in ("tokens", "mask", "y")))
                      for b in bc.buckets),
        perm=jnp.asarray(bc.perm.numpy()),
        inv_perm=jnp.asarray(bc.inv_perm.numpy()), ctr_stride=bc.ctr_stride,
        identity=bc.identity)


# ------------------------------------------------------------- segments

@pytest.mark.parametrize("n_buckets,lead", [(n, (90,)) for n in range(1, 7)]
                         + [(3, (3, 40))])
def test_stair_segments_round_trip_and_match_reference(n_buckets, lead):
    """Segments and back, at 1 to 6 buckets (and chain-sharded), integer
    equal to the reference's on the same schedule (the reference's
    functions read only its widths and counts; jitted once, as eager
    slices compile a program each)."""
    _, p_c = _lengths_corpus(40 + n_buckets, lead, n=64)
    p_bc = bucket_corpus(p_c, n_buckets, overhead_docs=0.0)
    assert len(p_bc.buckets) == n_buckets
    shape = types.SimpleNamespace(widths=p_bc.widths, counts=p_bc.counts)
    j_stair = jax.jit(lambda pieces: jtypes._stair_segments(shape, pieces))
    j_unstair = jax.jit(lambda segs: jtypes._unstair_segments(shape, segs))
    for f in ("tokens", "mask"):
        pieces = [getattr(b, f) for b in p_bc.buckets]
        p_segs = ptypes._stair_segments(p_bc, pieces)
        j_segs = j_stair([p.numpy() for p in pieces])
        assert len(p_segs) == n_buckets
        for j, p in zip(j_segs, p_segs):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        back = ptypes._unstair_segments(p_bc, p_segs)
        for piece, b in zip(back, pieces):
            assert torch.equal(piece, b)
        for j, p in zip(j_unstair(j_segs), back):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))


# ----------------------------------------------------------- prediction

def _models(p_train, m, cfg):
    """A chain ensemble trained at spl 1 on the padded shards."""
    shards = partition(p_train, m)
    z, draws = rng.train_draws(rng.chain_generators(1, m, "cpu"),
                               shards.n_docs, shards.max_len, 6, cfg.n_iters)
    return build_plan(shards, cfg).train(z, draws)[1]


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("m", [1, 4])
def test_stair_prediction_equals_blocks_and_padded(corpus_pair, m, mode):
    _, (p_train, p_test) = corpus_pair
    cfg = SLDAConfig(**CFG, n_iters=3, sampler_mode=mode)
    models = _models(p_train, m, cfg)
    z0, seeds = rng.predict_draws(rng.chain_generators(2, m, "cpu"),
                                  p_test.n_docs, p_test.max_len, 6)
    sched = bucket_corpus(p_test, 4, overhead_docs=0.0)
    assert len(sched.buckets) > 1
    stair = build_plan(sched, cfg)
    assert stair.executor == "stair"
    got = stair.predict(z0, seeds, models)
    blocks = build_plan(sched, cfg, executor="blocks").predict(z0, seeds,
                                                               models)
    padded = build_plan(p_test, cfg).predict(z0, seeds, models)
    assert torch.equal(got, blocks)
    assert torch.equal(got, padded)


def test_stair_prediction_matches_reference_jnp_route(corpus_pair):
    """The reference's bucketed plan on its `jnp` backend (its staircase
    executor) under its own draws, with the sparse draw: ŷ within 1e-4
    (`test_torch_ragged.py` holds the dense one at spl 1)."""
    (j_train, j_test), (p_train, p_test) = corpus_pair
    kw = dict(CFG, n_iters=3, sampler_mode="sparse", length_buckets=2,
              bucket_overhead_docs=0.0)
    j_cfg, p_cfg = JConfig(**kw), SLDAConfig(**kw)
    models = _models(p_train, 4, p_cfg)
    j_models = jplan.SLDAModel(*(jnp.asarray(getattr(models, f).numpy())
                                 for f in ("phi", "eta", "train_mse",
                                           "train_acc")))
    p_sched = build_schedule(p_test, p_cfg)
    j_sched = _reference_schedule(p_sched)
    assert jplan.build_plan(j_sched, j_cfg, "jnp").executor == "stair"
    keys = jax.random.split(jax.random.PRNGKey(6), 4)
    j_yhat = jax.jit(lambda k, c, mm: jplan.build_plan(
        c, j_cfg, "jnp").predict(k, mm))(keys, j_sched, j_models)
    z0, seeds = _ref_predict_draws(keys, 32, 32, 6)
    p_yhat = build_plan(p_sched, p_cfg).predict(
        _t(z0), _t(seeds), model_from_numpy(
            *(np.asarray(getattr(j_models, f)) for f in (
                "phi", "eta", "train_mse", "train_acc")), device="cpu"))
    np.testing.assert_allclose(p_yhat.numpy(), np.asarray(j_yhat),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- training

@pytest.mark.parametrize("product_form", [True, False])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_stair_one_sweep_launch_equals_blocks(corpus_pair, mode,
                                              product_form):
    """A launch of one sweep refreshes nothing: z and ndt bit for bit the
    blocks executor's, from the same state and seeds."""
    _, (p_train, _) = corpus_pair
    cfg = SLDAConfig(**CFG, n_iters=2, sweeps_per_launch=2,
                     sampler_mode=mode, product_form_sweeps=product_form)
    shards = partition(p_train, 4)
    sched = bucket_corpus(shards, 4, overhead_docs=0.0)
    stair, blocks = (build_plan(sched, cfg),
                     build_plan(sched, cfg, executor="blocks"))
    assert stair.executor == "stair" and blocks.executor == "blocks"
    z, _ = rng.train_draws(rng.chain_generators(3, 4, "cpu"),
                           shards.n_docs, shards.max_len, 6, 2, 2)
    state = stair.init_states(z)
    ntw = _word_major(state.ntw)
    index = stair._index(ntw)
    seeds = torch.randint(0, 2 ** 31 - 1, (4, shards.n_docs),
                          generator=torch.Generator().manual_seed(4),
                          dtype=torch.int32)
    z_s, ndt_s = stair._stair_launch(state, ntw, seeds, 1, index)
    z_b, ndt_b = blocks._blocks_launch(state, ntw, seeds, 1, index)
    for a, b in zip(z_s, z_b):
        assert torch.equal(a, b)
    assert torch.equal(ndt_s, ndt_b)


@pytest.mark.parametrize("mode,product_form", [("dense", True),
                                               ("sparse", False)])
def test_stair_training_matches_reference_jnp_route(corpus_pair, mode,
                                                    product_form):
    """Four sweeps a launch over two buckets under the reference's draws
    against its `jnp` bucketed plan, the staircase executor on both
    sides: the draws within the mismatch rule (the port sums
    Σ_t η_t·N_dt in the kernels' lane order), the counts rebuilt from z
    exact, η and φ̂ close.  Each draw and each product form once: the
    reference's compile takes 6 to 9 s a configuration."""
    _, (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=4, sweeps_per_launch=4, sampler_mode=mode,
              product_form_sweeps=product_form, length_buckets=2,
              bucket_overhead_docs=0.0)
    j_cfg, p_cfg = JConfig(**kw), SLDAConfig(**kw)
    p_sched = build_schedule(partition(p_train, 4), p_cfg)
    j_sched = _reference_schedule(p_sched)
    p_plan = build_plan(p_sched, p_cfg)
    assert p_plan.executor == "stair"
    assert jplan.build_plan(j_sched, j_cfg, "jnp").executor == "stair"
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    j_state, j_models = jax.jit(lambda k, c: jplan.build_plan(
        c, j_cfg, "jnp").train(k))(keys, j_sched)
    z, seeds = _ref_fused_draws(keys, 32, 32, 6, 1)
    p_state, p_models = p_plan.train(_t(z), (_t(s) for s in seeds))
    shards = partition(p_train, 4)
    mask = shards.mask.numpy()
    rate = float(((p_state.z.numpy() != np.asarray(j_state.z)) * mask).sum()
                 / mask.sum())
    print(f"stair training at spl 4, {mode}, product_form={product_form}, "
          f"under the reference's draws: draw mismatch {rate:.2e}")
    assert rate <= MISMATCH_MAX
    counts = counts_from_assignments(shards.tokens, shards.mask, p_state.z,
                                     6, 60)
    for f, c in zip(("ndt", "ntw", "nt"), counts):
        assert torch.equal(getattr(p_state, f), c)
    np.testing.assert_allclose(p_models.eta.numpy(),
                               np.asarray(j_models.eta), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p_models.phi.numpy(),
                               np.asarray(j_models.phi), rtol=1e-3, atol=1e-6)


# -------------------------------------------------------------- routing

@pytest.mark.parametrize("n_buckets,forced,backend", [
    (1, None, "jnp"), (4, None, "jnp"), (4, "blocks", "pallas-interpret")])
def test_executor_equals_reference(corpus_pair, n_buckets, forced, backend):
    """(CPU, one bucket) blocks, (CPU, several) stair, an explicit
    "blocks" the reference's Pallas route: the describe()s agree."""
    (j_train, _), (p_train, _) = corpus_pair
    kw = dict(CFG, n_iters=4, sweeps_per_launch=2,
              length_buckets=0 if n_buckets == 1 else n_buckets,
              bucket_overhead_docs=0.0)
    j_cfg, p_cfg = JConfig(**kw), SLDAConfig(**kw)
    p_sched = build_schedule(partition(p_train, 4), p_cfg)
    j_sched = (_reference_schedule(p_sched) if n_buckets > 1 else
               jplan.build_schedule(jtypes.partition(j_train, 4), j_cfg))
    j_d = jplan.build_plan(j_sched, j_cfg, backend).describe()
    p_d = build_plan(p_sched, p_cfg, executor=forced).describe()
    assert p_d["executor"] == j_d["executor"]
    assert p_d["buckets"] == j_d["buckets"]
    assert (p_d["buckets"] > 1) is (n_buckets > 1)


def test_stair_refuses_a_device_corpus_and_unknown_executors():
    meta = ptypes.Corpus(torch.zeros((4, 8), dtype=torch.int32,
                                     device="meta"),
                         torch.ones((4, 8), device="meta"),
                         torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CPU only"):
        build_plan(meta, SLDAConfig(), executor="stair")
    assert build_plan(meta, SLDAConfig(), executor="blocks").executor == \
        "blocks"
    assert build_plan(meta, SLDAConfig()).executor == "blocks"
    with pytest.raises(ValueError, match="executor"):
        build_plan(meta, SLDAConfig(), executor="pallas")
