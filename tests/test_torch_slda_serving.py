"""The port's sLDA prediction service (`repro_torch.serving`) on the CPU:
every test of tests/test_slda_serving.py and the service's mode switch of
tests/test_sparse_sampler.py on the port, then the port against the
reference's service on the same trace under the reference's own draws,
and `calibrate_slots` against the reference's on drawn length samples.

The models are the reference's tests' (trained by `repro.core`), carried
across with `convert.model_from_numpy`."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import SLDAConfig as JConfig
from repro.core import partition as j_partition
from repro.core import train_chains as j_train_chains
from repro.data import make_slda_corpus as j_make
from repro.serving import ServiceConfig as JServiceConfig
from repro.serving import SLDAPredictionService as JService
from repro.serving.slda_service import calibrate_slots as j_calibrate_slots
from repro_torch.convert import model_from_numpy
from repro_torch.core import SLDAConfig, bucket_corpus, bucket_signature
from repro_torch.core import build_plan
from repro_torch.core.plan import as_bucketed
from repro_torch.data import make_slda_corpus
from repro_torch.serving import ServiceConfig, SLDAPredictionService
from repro_torch.serving.slda_service import (_combine_yhat, calibrate_slots,
                                              eager_dispatch)

CFG_KW = dict(n_topics=8, vocab_size=64, n_iters=3, n_pred_burnin=2,
              n_pred_samples=2)
CFG = SLDAConfig(**CFG_KW)
MAXLEN, M, BATCH = 48, 2, 16

_corpus, _ = j_make(jax.random.PRNGKey(0), 64, CFG.vocab_size, CFG.n_topics,
                    MAXLEN, doc_len_dist="lognormal", len_sigma=1.0)
J_MODELS = j_train_chains(jax.random.PRNGKey(1), j_partition(_corpus, M),
                          JConfig(**CFG_KW))


def _port_models(jm):
    return model_from_numpy(jm.phi, jm.eta, jm.train_mse, jm.train_acc,
                            device="cpu")


MODELS = _port_models(J_MODELS)
LENS = np.asarray(_corpus.mask.sum(-1)).astype(int)
TOKS = np.asarray(_corpus.tokens)
DOCS = [TOKS[d, :LENS[d]] for d in range(_corpus.n_docs)]
SVC = ServiceConfig.calibrated(LENS, max_doc_len=MAXLEN, batch_docs=BATCH,
                               n_buckets=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_service(**kw):
    svc = dataclasses.replace(SVC, **kw) if kw else SVC
    return SLDAPredictionService(MODELS, CFG, svc, seed=9, device="cpu")


# ------------------------------------------------------- dispatch cache

def test_steady_state_traffic_never_retraces():
    """Recurring traffic has one bucket signature, hence one cached
    dispatch: the build counter stops growing after the first batch."""
    svc = make_service(cache_results=False)   # every doc really dispatches
    for d in DOCS[:BATCH]:
        svc.submit(d)
    warm = svc.stats()["traces"]
    assert warm == 1 and svc.stats()["compiled_plans"] == 1
    for rep in range(3):                      # steady state: reuse + drain
        for d in DOCS[rep * 8: rep * 8 + 20]:
            svc.submit(d)
        svc.drain()
    st_ = svc.stats()
    assert st_["traces"] == warm
    assert st_["compiled_plans"] == 1
    assert st_["dispatches"] >= 4


def test_dispatch_matches_uncached_plan_layer():
    """The serving machinery (slot packing, dispatch cache, combine) adds
    no deviation: a service whose dispatch builds a fresh callable at
    every flush returns the same bits."""
    class OfflineService(SLDAPredictionService):
        def _dispatch_fn(self, plan_key):
            return lambda *args: eager_dispatch(*args)

    svc = make_service()
    off = OfflineService(MODELS, CFG, SVC, seed=9, device="cpu")
    rids_a = [svc.submit(d) for d in DOCS[:24]]
    rids_b = [off.submit(d) for d in DOCS[:24]]
    svc.drain(), off.drain()
    for ra, rb in zip(rids_a, rids_b):
        a, b = svc.result(ra), off.result(rb)
        assert a.yhat == b.yhat
        np.testing.assert_array_equal(a.yhat_chains, b.yhat_chains)
        np.testing.assert_array_equal(a.zbar, b.zbar)


# ----------------------------------------------- bucketed/padded parity

def test_bucketed_vs_padded_bitwise_parity():
    """The same traffic through the bucketed and the padded dispatch
    layouts: per-document results equal bit for bit (the counter stride
    pinned to max_doc_len)."""
    bkt = make_service(bucketed=True)
    pad = make_service(bucketed=False)
    rids_a = [bkt.submit(d) for d in DOCS[:40]]
    rids_b = [pad.submit(d) for d in DOCS[:40]]
    bkt.drain(), pad.drain()
    assert bkt.stats()["compiled_plans"] == 1
    assert pad.stats()["compiled_plans"] == 1
    for ra, rb in zip(rids_a, rids_b):
        a, b = bkt.result(ra), pad.result(rb)
        assert a.yhat == b.yhat
        np.testing.assert_array_equal(a.yhat_chains, b.yhat_chains)
        np.testing.assert_array_equal(a.zbar, b.zbar)


# --------------------------------------------------------- result cache

def test_repeat_documents_hit_result_cache():
    svc = make_service()
    rid0 = [svc.submit(d) for d in DOCS[:BATCH]]
    svc.drain()
    st0 = svc.stats()
    assert st0["result_cache_hits"] == 0
    rid1 = [svc.submit(d) for d in DOCS[:BATCH]]   # same content again
    st_ = svc.stats()
    assert st_["result_cache_hits"] == BATCH
    assert st_["dispatches"] == st0["dispatches"]  # no new dispatch
    for a, b in zip(rid0, rid1):
        ra, rb = svc.result(a), svc.result(b)
        assert rb.from_cache and not ra.from_cache
        assert ra.yhat == rb.yhat
        np.testing.assert_array_equal(ra.zbar, rb.zbar)


def test_cache_hit_combines_under_current_weights():
    """A cached document re-served after drop_chain combines its cached
    per-chain values under the new mask: with one of two chains dropped,
    the combined ŷ is the survivor's."""
    svc = make_service()
    rid0 = svc.submit(DOCS[0])
    for d in DOCS[1:BATCH]:
        svc.submit(d)
    svc.drain()
    svc.drop_chain(1)
    rid1 = svc.submit(DOCS[0])                     # cache hit, new weights
    r0, r1 = svc.result(rid0), svc.result(rid1)
    assert r1.from_cache
    np.testing.assert_array_equal(r0.yhat_chains, r1.yhat_chains)
    assert r1.yhat == pytest.approx(float(r0.yhat_chains[0]))
    assert svc.combined(rid0) == r1.yhat           # re-derive == re-serve


# ----------------------------------------------- mid-stream drop/revive

def test_drop_revive_mid_stream_without_retrace():
    """The weights never enter a cached dispatch: dropping a chain between
    batches changes the served combine without a new build, and a revive
    restores the first outputs exactly; the in-flush combine of a batch
    equals the host re-derivation of one document bit for bit."""
    svc = make_service(cache_results=False)
    rids0 = [svc.submit(d) for d in DOCS[:BATCH]]
    svc.drain()
    traces = svc.stats()["traces"]

    svc.drop_chain(1)
    rids1 = [svc.submit(d) for d in DOCS[:BATCH]]  # same docs, same slots
    svc.drain()
    svc.revive_chain(1)
    rids2 = [svc.submit(d) for d in DOCS[:BATCH]]
    svc.drain()
    assert svc.stats()["traces"] == traces         # no build on either

    w_full = torch.ones(M)
    for r0, r1, r2 in zip(rids0, rids1, rids2):
        a, b, c = svc.result(r0), svc.result(r1), svc.result(r2)
        assert b.yhat == float(b.yhat_chains[0])
        assert b.yhat != a.yhat
        exp = float(_combine_yhat(
            SVC.combine, torch.as_tensor(c.yhat_chains)[:, None], w_full,
            MODELS.train_mse)[0])
        assert c.yhat == exp
        assert a.yhat == float(_combine_yhat(
            SVC.combine, torch.as_tensor(a.yhat_chains)[:, None], w_full,
            MODELS.train_mse)[0])


@pytest.mark.parametrize("rule", ["simple", "weighted", "median"])
def test_combine_is_column_independent(rule):
    """`_combine_yhat` (`core.combine`) gives a document the same bits
    combined alone ([M, 1], `combined()`, cache hits) as in a batch
    ([M, D], a flush), and a chain of weight 0 gives the survivors'
    combine bit for bit (a matmul orders a column's sum by the batch's
    width: `w @ y` failed the first check)."""
    rng = np.random.default_rng(5)
    for m in (2, 4, 8):
        y = torch.from_numpy(rng.normal(size=(m, 64)).astype(np.float32))
        mse = torch.from_numpy(rng.uniform(0.1, 2.0, m).astype(np.float32))
        dropped = torch.ones(m)
        dropped[1] = 0.0
        for w in (torch.ones(m), dropped):
            batch = _combine_yhat(rule, y, w, mse)
            alone = torch.stack([_combine_yhat(rule, y[:, d:d + 1], w,
                                               mse)[0] for d in range(64)])
            assert torch.equal(batch, alone)
        surv = [c for c in range(m) if c != 1]
        assert torch.equal(_combine_yhat(rule, y, dropped, mse),
                           _combine_yhat(rule, y[surv], torch.ones(m - 1),
                                         mse[surv]))


# ------------------------------------------------ batching edge cases

def test_partial_batch_drain_pads_with_dummies():
    svc = make_service(cache_results=False)
    rids = [svc.submit(d) for d in DOCS[:3]]
    assert svc.stats()["dispatches"] == 0          # below batch_docs
    done = svc.drain()
    assert sorted(done) == sorted(rids)
    st_ = svc.stats()
    assert st_["dispatches"] == 1
    assert st_["dummy_slots"] == BATCH - 3


def test_rung_overflow_escalates_then_rolls_over():
    """More max-length docs than the widest rung's slots roll over to
    further micro-batches; everything is served."""
    svc = make_service(cache_results=False)
    long_doc = np.arange(MAXLEN, dtype=np.int32) % CFG.vocab_size
    rids = [svc.submit(long_doc + i % 2) for i in range(BATCH)]
    svc.drain()
    assert svc.stats()["dispatches"] > 1
    for rid in rids:
        assert np.isfinite(svc.result(rid).yhat)


def test_short_doc_escalates_into_wider_free_slot():
    """When a narrow rung fills up, later short docs take wider slots."""
    svc = make_service(cache_results=False)
    w0, q0 = SVC.width_ladder[0], SVC.slot_quota[0]
    short = np.ones((max(1, w0 - 1),), np.int32)
    rids = [svc.submit(short + i) for i in range(q0 + 2)]
    done = svc.drain()
    assert svc.stats()["dispatches"] == 1          # all fit one batch
    assert sorted(done) == sorted(rids)


def test_submit_validation():
    svc = make_service()
    with pytest.raises(ValueError):
        svc.submit(np.ones((MAXLEN + 1,), np.int32))
    with pytest.raises(ValueError):
        svc.submit(np.asarray([], np.int32))
    with pytest.raises(ValueError):
        svc.submit(np.asarray([CFG.vocab_size], np.int32))


# ------------------------------------- cache-key / calibration surface

def _port_corpus():
    from repro_torch.convert import corpus_from_numpy
    return corpus_from_numpy(_corpus.tokens, _corpus.mask, _corpus.y,
                             device="cpu")


def test_bucket_signature_identifies_schedule_shape():
    corpus = _port_corpus()
    sig = bucket_signature(bucket_corpus(corpus, 3))
    sig2 = bucket_signature(bucket_corpus(corpus, 3))
    assert sig == sig2 and hash(sig) == hash(sig2)
    assert sig != bucket_signature(as_bucketed(corpus))
    plan = build_plan(bucket_corpus(corpus, 3), CFG)
    assert plan.cache_key() == (sig, CFG)


def test_calibrate_slots_layout_invariants():
    widths, quota = calibrate_slots(LENS, BATCH, MAXLEN, n_buckets=3)
    assert sum(quota) == BATCH and min(quota) >= 1
    assert list(widths) == sorted(set(widths))
    assert widths[-1] == MAXLEN
    # degenerate: one giant rung
    w1, q1 = calibrate_slots([5, 5, 5], 4, MAXLEN, n_buckets=1)
    assert w1 == (MAXLEN,) and q1 == (4,)


@pytest.mark.parametrize("ladder, quota", [
    ((32, 16, 64), (1, 1, 2)),       # not ascending
    ((16, 32), (2, 2)),              # widest rung is not max_doc_len
    ((16, 64), (2, 3)),              # quota does not sum to batch_docs
])
def test_service_config_validation(ladder, quota):
    with pytest.raises(ValueError):
        ServiceConfig(max_doc_len=64, batch_docs=4, width_ladder=ladder,
                      slot_quota=quota)


def test_service_mode_switch_allocates_distinct_callable():
    """`set_sampler_mode` puts the new cfg in every later dispatch key:
    the next flush builds a new callable, switching back builds none, and
    `stats()` reports the active mode and the key count."""
    from repro_torch.core import train_chains
    cfg = SLDAConfig(n_topics=8, vocab_size=64, n_iters=3,
                     n_pred_burnin=1, n_pred_samples=2)
    corp, _ = make_slda_corpus(0, 48, 64, 8, 32, doc_len_dist="lognormal",
                               device="cpu")
    from repro_torch.core import partition
    _, models = train_chains(1, partition(corp, 2), cfg, device="cpu")
    lens = corp.mask.sum(-1).to(torch.int64).numpy()
    svc_cfg = ServiceConfig.calibrated(lens, max_doc_len=32, batch_docs=8,
                                       n_buckets=2)
    svc = SLDAPredictionService(models, cfg, svc_cfg, seed=9, device="cpu")
    toks = corp.tokens.numpy()
    docs = [toks[d, :max(int(lens[d]), 1)] for d in range(24)]

    for d in docs[:8]:
        svc.submit(d)
    st_ = svc.stats()
    assert st_["sampler_mode"] == "dense"
    assert st_["plan_cache_keys"] == st_["compiled_plans"] == 1

    svc.set_sampler_mode("sparse")
    for d in docs[8:16]:
        svc.submit(d)
    svc.drain()
    st_ = svc.stats()
    assert st_["sampler_mode"] == "sparse"
    assert st_["plan_cache_keys"] == st_["traces"] == 2
    for rid in range(16):
        assert np.isfinite(svc.result(rid).yhat)

    svc.set_sampler_mode("dense")
    for d in docs[16:24]:
        svc.submit(d)
    svc.drain()
    st_ = svc.stats()
    assert st_["sampler_mode"] == "dense"
    assert st_["traces"] == st_["plan_cache_keys"] == 2   # back: free
    with pytest.raises(ValueError):
        svc.set_sampler_mode("dense-ish")


# ---------------------------------------- the port against the reference

@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _ref_predict_draws(keys, d, n, t):
    """z0 and per-document seeds of the reference's `predict_zbar(keys)`."""
    ks = jax.vmap(jax.random.split)(keys)
    z0 = jax.vmap(lambda k: jax.random.randint(k, (d, n), 0, t, jnp.int32))(
        ks[:, 0])
    seeds = jax.vmap(lambda k: jax.random.randint(
        k, (d,), 0, jnp.iinfo(jnp.int32).max, jnp.int32))(ks[:, 1])
    return z0, seeds


def ref_draws(b: int, m: int = M, d: int = BATCH, s: int = MAXLEN):
    """The draws of the reference service's micro-batch b (its
    `split(fold_in(PRNGKey(9), b), M)` keys), as torch tensors."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), b), m)
    z0, seeds = _ref_predict_draws(keys, d, s, CFG.n_topics)
    return torch.from_numpy(np.array(z0)), torch.from_numpy(np.array(seeds))


@pytest.mark.parametrize("bucketed", [True, False])
def test_service_matches_reference_under_its_draws(bucketed):
    """One trace (40 documents, then 8 repeats, a drop, 8 more documents,
    a drain) through the reference's service and the port's, the port
    drawing the reference's numbers: equal statuses, cache flags and
    counters; z̄ within 1e-6 and ŷ within 1e-4."""
    kw = dict(bucketed=bucketed)
    jsvc = JService(J_MODELS, JConfig(**CFG_KW),
                    dataclasses.replace(JServiceConfig.calibrated(
                        LENS, max_doc_len=MAXLEN, batch_docs=BATCH,
                        n_buckets=3), **kw),
                    key=jax.random.PRNGKey(9))
    psvc = SLDAPredictionService(MODELS, CFG, dataclasses.replace(SVC, **kw),
                                 device="cpu", draws=ref_draws)
    assert SVC.width_ladder == jsvc.svc.width_ladder
    assert SVC.slot_quota == jsvc.svc.slot_quota
    trace = DOCS[:40] + DOCS[:8]
    ids = []
    for svc in (jsvc, psvc):
        rids = [svc.submit(d) for d in trace]
        svc.drop_chain(1)
        rids += [svc.submit(d) for d in DOCS[40:48]]
        svc.drain()
        ids.append(rids)
    n_diff = n_all = 0
    for rj, rp in zip(*ids):
        a, b = jsvc.result(rj), psvc.result(rp)
        assert a.status == b.status and a.from_cache == b.from_cache
        n_diff += int((np.abs(np.asarray(a.zbar) - b.zbar) > 1e-6).sum())
        n_all += b.zbar.size
        np.testing.assert_allclose(b.zbar, np.asarray(a.zbar), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(b.yhat_chains, np.asarray(a.yhat_chains),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b.yhat, a.yhat, rtol=1e-4, atol=1e-4)
    print(f"served z̄ entries off the reference's by more than 1e-6 "
          f"(a draw mismatch moves one by >= 1/(n_samples·len)): "
          f"{n_diff} of {n_all} = {n_diff / n_all:.2e}")
    sj, sp = jsvc.stats(), psvc.stats()
    for k in ("dispatches", "docs_dispatched", "dummy_slots",
              "dummy_slot_frac", "result_cache_hits", "result_cache_size",
              "width_ladder", "slot_quota", "traces", "compiled_plans",
              "alive_chains", "queue_depth", "dispatch_quarantines",
              "load_quarantines", "chain_health"):
        assert sp[k] == sj[k], k


@settings(max_examples=40, deadline=None)
@given(lengths=st.lists(st.integers(1, 300), min_size=1, max_size=200),
       batch=st.integers(1, 48), max_len=st.sampled_from([64, 120, 256]),
       n_buckets=st.integers(1, 6), overhead=st.sampled_from([0.0, 4.0]))
def test_calibrate_slots_matches_reference(lengths, batch, max_len,
                                           n_buckets, overhead):
    kw = dict(n_buckets=n_buckets, overhead_docs=overhead)
    assert calibrate_slots(lengths, batch, max_len, **kw) == \
        j_calibrate_slots(lengths, batch, max_len, **kw)


def _module(path: str):
    """A file of the repository as a module (chip_smoke.py, a benchmark)."""
    full = Path(__file__).resolve().parents[1] / path
    spec = importlib.util.spec_from_file_location(full.stem, full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_trace_is_the_reference_benchmarks():
    """`chip_smoke.py`'s bench_shape trace is the reference benchmark's
    `make_trace(123, 512, 1000, 256)` bit for bit (its documents and its
    25% verbatim repeats)."""
    smoke = _module("chip_smoke.py")
    bench = _module("benchmarks/bench_slda_serving.py")
    want = bench.make_trace(123, 512, 1000, 256)
    got, ids = smoke.serve_trace(123, 512, smoke.lognormal_doc(1000, 256))
    assert len(got) == len(want) == 512 and ids == [-1] * 512
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want))
