"""The port's serving robustness on the CPU: every test of
tests/test_serving_robust.py on the port's service and the port's fault
helpers (`VirtualClock`, `burst_trace`, `inject_dispatch_delay`,
`replay_open_loop`), then the burst replay's per-request statuses against
the reference's on the same trace and clock, a reload from a checkpoint
the reference wrote, and the service refusing the card where there is
none."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.core import SLDAConfig as JConfig
from repro.core import partition as j_partition
from repro.core import train_chains as j_train_chains
from repro.data import make_slda_corpus as j_make
from repro.serving import SLDAPredictionService as JService
from repro.testing import VirtualClock as JVirtualClock
from repro.testing import burst_trace as j_burst_trace
from repro.testing import inject_dispatch_delay as j_inject_dispatch_delay
from repro.testing import replay_open_loop as j_replay_open_loop
from repro_torch.checkpoint import save_checkpoint
from repro_torch.convert import model_from_numpy
from repro_torch.core import SLDAConfig
from repro_torch.serving import (InvalidDocument, ServiceConfig,
                                 SLDAPredictionService, STATUS_EXPIRED,
                                 STATUS_OK, STATUS_SHED_QUEUE,
                                 STATUS_SHED_RATE)
from repro_torch.serving.slda_service import _combine_yhat
from repro_torch.testing import (VirtualClock, burst_trace,
                                 inject_dispatch_delay, mislabel_manifest,
                                 poison_model_table, replay_open_loop,
                                 truncate_chain_file)

CFG_KW = dict(n_topics=8, vocab_size=64, n_iters=3, n_pred_burnin=2,
              n_pred_samples=2)
CFG = SLDAConfig(**CFG_KW)
MAXLEN, M, BATCH = 48, 4, 16

_corpus, _ = j_make(jax.random.PRNGKey(0), 64, CFG.vocab_size, CFG.n_topics,
                    MAXLEN, doc_len_dist="lognormal", len_sigma=1.0)
J_MODELS = j_train_chains(jax.random.PRNGKey(1), j_partition(_corpus, M),
                          JConfig(**CFG_KW))
J_MODELS_B = j_train_chains(jax.random.PRNGKey(7), j_partition(_corpus, M),
                            JConfig(**CFG_KW))


def _port_models(jm):
    return model_from_numpy(jm.phi, jm.eta, jm.train_mse, jm.train_acc,
                            device="cpu")


MODELS, MODELS_B = _port_models(J_MODELS), _port_models(J_MODELS_B)
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


def make_service(models=MODELS, **kw):
    clock = kw.pop("clock", None)
    svc = dataclasses.replace(SVC, **kw) if kw else SVC
    return SLDAPredictionService(models, CFG, svc, seed=9, device="cpu",
                                 clock=clock)


# ------------------------------------------- admission control + deadlines

def test_queue_bound_sheds_typed():
    """At the `max_pending` cap a new submission resolves to a typed
    STATUS_SHED_QUEUE Result, and the queued requests are untouched."""
    svc = make_service(max_pending=BATCH, auto_flush=False,
                       cache_results=False)
    kept = [svc.submit(DOCS[i]) for i in range(BATCH)]
    shed = [svc.submit(DOCS[BATCH + i]) for i in range(3)]
    st = svc.stats()
    assert st["queue_depth"] == BATCH
    assert st["shed_queue_full"] == 3
    for rid in shed:
        r = svc.result(rid)
        assert r.status == STATUS_SHED_QUEUE
        assert np.isnan(r.yhat) and r.yhat_chains is None
        with pytest.raises(ValueError):
            svc.combined(rid)
    svc.drain()
    for rid in kept:
        assert svc.result(rid).status == STATUS_OK


def test_rate_limiter_token_bucket():
    """`rate_burst` requests pass at once, further ones shed
    STATUS_SHED_RATE until simulated time refills the bucket."""
    clock = VirtualClock()
    svc = make_service(rate_limit_per_s=1.0, rate_burst=2,
                       auto_flush=False, cache_results=False, clock=clock)
    r0 = svc.submit(DOCS[0])
    r1 = svc.submit(DOCS[1])
    r2 = svc.submit(DOCS[2])                    # bucket empty
    assert svc.result(r2).status == STATUS_SHED_RATE
    assert r0 not in svc._results and r1 not in svc._results  # queued
    clock.advance(1.0)                          # one token refills
    r3 = svc.submit(DOCS[3])
    r4 = svc.submit(DOCS[4])
    assert r3 not in svc._results               # admitted
    assert svc.result(r4).status == STATUS_SHED_RATE
    assert svc.stats()["shed_rate_limit"] == 2


def test_deadline_expiry_sheds_before_dispatch():
    """A lapsed request is shed at pack time, before it takes a slot: with
    every request expired the flush dispatches nothing."""
    clock = VirtualClock()
    svc = make_service(auto_flush=False, cache_results=False, clock=clock)
    rids = [svc.submit(DOCS[i], deadline_s=1.0) for i in range(4)]
    clock.advance(2.0)                          # all deadlines lapse
    svc.flush()
    st = svc.stats()
    assert st["dispatches"] == 0
    assert st["expired"] == 4
    for rid in rids:
        assert svc.result(rid).status == STATUS_EXPIRED


def test_mixed_expired_and_live_flush():
    clock = VirtualClock()
    svc = make_service(auto_flush=False, cache_results=False, clock=clock)
    dead = [svc.submit(DOCS[i], deadline_s=0.5) for i in range(3)]
    live = [svc.submit(DOCS[3 + i]) for i in range(3)]   # no deadline
    clock.advance(1.0)
    svc.flush()
    assert all(svc.result(r).status == STATUS_EXPIRED for r in dead)
    assert all(svc.result(r).status == STATUS_OK for r in live)
    assert svc.stats()["dispatches"] == 1


def test_earliest_deadline_first_packing():
    """With the widest rung oversubscribed, the earliest deadline takes a
    slot though submitted last; a deadline-free request rolls over."""
    q_last = SVC.slot_quota[-1]
    svc = make_service(auto_flush=False, cache_results=False)
    long_doc = np.arange(MAXLEN, dtype=np.int32) % CFG.vocab_size
    fifo = [svc.submit((long_doc + i) % CFG.vocab_size)
            for i in range(q_last)]
    urgent = svc.submit((long_doc + 63) % CFG.vocab_size, deadline_s=100.0)
    done = svc.flush()
    assert urgent in done                       # EDF won the last slot
    assert fifo[-1] not in done                 # latest FIFO doc rolled
    assert svc.stats()["queue_depth"] == 1
    svc.drain()
    assert svc.result(fifo[-1]).status == STATUS_OK


def test_no_deadlines_reduces_to_fifo():
    """EDF with every deadline +inf is the FIFO packing: the same docs
    through a robust and a deadline-free service give the same bits."""
    a = make_service(cache_results=False)
    b = make_service(cache_results=False, max_pending=64,
                     default_deadline_s=1e6)
    rids_a = [a.submit(d) for d in DOCS[:24]]
    rids_b = [b.submit(d) for d in DOCS[:24]]
    a.drain(), b.drain()
    for ra, rb in zip(rids_a, rids_b):
        assert a.result(ra).yhat == b.result(rb).yhat
        np.testing.assert_array_equal(a.result(ra).yhat_chains,
                                      b.result(rb).yhat_chains)


def test_drain_deadline_bounds_wall_time():
    """`drain(deadline_s=...)` stops flushing at the bound; the rest stays
    pending (not shed) and a later drain serves it."""
    clock = VirtualClock()
    svc = make_service(auto_flush=False, cache_results=False, clock=clock)
    undo = inject_dispatch_delay(svc, 1.0)      # 1 s per micro-batch
    rids = [svc.submit(DOCS[i % len(DOCS)][: 1 + i % MAXLEN] + 0)
            for i in range(3 * BATCH)]
    svc.drain(deadline_s=1.5)                   # time for 2 flushes only
    st = svc.stats()
    assert st["drain_timeouts"] == 1
    assert st["queue_depth"] == BATCH
    undo()
    svc.drain()
    assert svc.stats()["queue_depth"] == 0
    assert all(svc.result(r).status == STATUS_OK for r in rids)


@pytest.mark.parametrize("doc, reason", [
    (np.asarray([], np.int32), "empty_doc"),
    (np.ones((MAXLEN + 1,), np.int32), "doc_too_long"),
    (np.asarray([CFG.vocab_size], np.int32), "bad_token_id"),
    (np.asarray([-1], np.int32), "bad_token_id"),
])
def test_invalid_document_typed_rejections(doc, reason):
    svc = make_service()
    with pytest.raises(InvalidDocument) as ei:
        svc.submit(doc)
    assert ei.value.reason == reason
    assert isinstance(ei.value, ValueError)     # old handlers still work
    assert svc.stats()["rejected_invalid"] == 1
    assert svc.stats()["queue_depth"] == 0      # nothing half-admitted


# --------------------------------------- health screening + degraded mode

def test_poisoned_table_quarantined_at_load_degraded_exact():
    """A chain with a NaN φ̂ is quarantined at load, and the degraded
    service is exact: bit-equal to a clean service with the chain
    dropped."""
    bad = make_service(poison_model_table(MODELS, 1, "nan_phi"),
                       cache_results=False)
    st = bad.stats()
    assert st["alive_chains"] == M - 1
    assert st["load_quarantines"] == 1
    assert "nan_phi" in st["chain_health"][1]
    clean = make_service(cache_results=False)
    clean.drop_chain(1)
    rids_a = [bad.submit(d) for d in DOCS[:BATCH]]
    rids_b = [clean.submit(d) for d in DOCS[:BATCH]]
    bad.drain(), clean.drain()
    survivors = [c for c in range(M) if c != 1]
    for ra, rb in zip(rids_a, rids_b):
        a, b = bad.result(ra), clean.result(rb)
        assert a.yhat == b.yhat
        np.testing.assert_array_equal(a.yhat_chains[survivors],
                                      b.yhat_chains[survivors])


@pytest.mark.parametrize("kind", ["nan_eta", "bad_rowsum", "nan_mse"])
def test_model_screen_catches_every_table_fault(kind):
    svc = make_service(poison_model_table(MODELS, 2, kind))
    st = svc.stats()
    assert st["alive_chains"] == M - 1
    assert float(np.asarray(svc.chain_weights)[2]) == 0.0


def test_checks_off_serves_unscreened():
    """robust_checks=False: the poisoned chain keeps its weight."""
    svc = make_service(poison_model_table(MODELS, 1, "nan_phi"),
                       robust_checks=False)
    assert svc.stats()["alive_chains"] == M


def test_dispatch_nan_quarantine_recombines():
    """Corruption after load: the first dispatch with a non-finite
    per-chain ŷ quarantines the chain and recombines, so the caller sees
    the pre-dropped clean service's ŷ."""
    svc = make_service(cache_results=False)
    svc.models = poison_model_table(MODELS, 3, "nan_eta")  # post-screen
    clean = make_service(cache_results=False)
    clean.drop_chain(3)
    rids_a = [svc.submit(d) for d in DOCS[:BATCH]]
    rids_b = [clean.submit(d) for d in DOCS[:BATCH]]
    svc.drain(), clean.drain()
    st = svc.stats()
    assert st["dispatch_quarantines"] == 1
    assert "nan_yhat" in st["chain_health"][3]
    assert float(np.asarray(svc.chain_weights)[3]) == 0.0
    for ra, rb in zip(rids_a, rids_b):
        a, b = svc.result(ra), clean.result(rb)
        assert np.isfinite(a.yhat)
        assert a.yhat == b.yhat


def test_all_chains_dead_warns_and_serves_fallback():
    """Every chain dropped: `combined()` is the unmasked combine with a
    RuntimeWarning, and a fresh dispatch still serves finite numbers."""
    svc = make_service(cache_results=False)
    rids = [svc.submit(d) for d in DOCS[:BATCH]]
    svc.drain()
    for c in range(M):
        svc.drop_chain(c)
    r = svc.result(rids[0])
    with pytest.warns(RuntimeWarning, match="all-dead"):
        got = svc.combined(rids[0])
    exp = float(_combine_yhat(SVC.combine,
                              torch.as_tensor(r.yhat_chains)[:, None],
                              torch.ones(M), MODELS.train_mse)[0])
    assert got == exp
    with pytest.warns(RuntimeWarning, match="all-dead"):
        rids2 = [svc.submit(d) for d in DOCS[BATCH:2 * BATCH]]
        svc.drain()
    for rid in rids2:
        assert np.isfinite(svc.result(rid).yhat)


# ----------------------------------------------------- hot model reload

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hot_reload_bumps_epoch_invalidates_cache_no_retrace(tmp_path,
                                                             writer):
    """Swap to a checkpointed model (written by this package or by the
    reference's `save_checkpoint`): the epoch bumps, the (hash, epoch) key
    retires every cached result, results under the new epoch equal a
    fresh service's on the new models, and nothing is built anew."""
    if writer == "port":
        save_checkpoint(str(tmp_path), 5, MODELS_B)
    else:
        j_save_checkpoint(str(tmp_path), 5, J_MODELS_B)
    svc = make_service()
    [svc.submit(d) for d in DOCS[:BATCH]]
    svc.drain()
    hit = svc.submit(DOCS[0])
    assert svc.result(hit).from_cache            # cache warm, epoch 0
    traces = svc.stats()["traces"]
    rep = svc.reload_from_checkpoint(str(tmp_path))
    assert rep["ok"] and rep["epoch"] == 1 and rep["ckpt_step"] == 5
    miss = svc.submit(DOCS[0])                   # same bytes, new epoch
    svc.drain()
    r = svc.result(miss)
    assert not r.from_cache                      # stale epoch never served
    fresh = make_service(MODELS_B)
    fresh._batches = svc._batches - 1            # align the draws
    rid = fresh.submit(DOCS[0])
    fresh.drain()
    assert r.yhat == fresh.result(rid).yhat
    np.testing.assert_array_equal(r.zbar, fresh.result(rid).zbar)
    st = svc.stats()
    assert st["traces"] == traces                # a swap builds nothing
    assert st["model_epoch"] == 1 and st["reloads_ok"] == 1


def test_torn_reload_rejected_old_epoch_keeps_serving(tmp_path):
    """A torn checkpoint (a truncated chain file) is rejected: the old
    models serve on under the old epoch and the warm cache stays valid."""
    save_checkpoint(str(tmp_path), 3, MODELS_B)
    truncate_chain_file(str(tmp_path), 3, 1)
    svc = make_service()
    rid0 = [svc.submit(d) for d in DOCS[:BATCH]][0]
    y0 = svc.result(rid0).yhat
    rep = svc.reload_from_checkpoint(str(tmp_path))
    assert not rep["ok"] and rep["epoch"] == 0
    st = svc.stats()
    assert st["reloads_rejected"] == 1 and st["model_epoch"] == 0
    again = svc.submit(DOCS[0])
    assert svc.result(again).from_cache          # cache not invalidated
    assert svc.result(again).yhat == y0


def _half_chains(tmp_path):
    save_checkpoint(str(tmp_path), 1, MODELS_B.map(lambda x: x[: M // 2]))
    return None, "chains"


def _mislabelled(tmp_path):
    save_checkpoint(str(tmp_path), 4, MODELS_B)
    mislabel_manifest(str(tmp_path), 4, 99)
    return 4, "mislabelled"


def _missing(tmp_path):
    return None, "no checkpoint"


def _narrow_vocab(tmp_path):
    save_checkpoint(str(tmp_path), 2, MODELS_B.map(
        lambda x: x[..., :CFG.vocab_size // 2] if x.dim() == 3 else x))
    return None, "shape mismatch"


@pytest.mark.parametrize("make_ckpt", [_mislabelled, _half_chains,
                                       _missing, _narrow_vocab],
                         ids=["mislabelled_manifest",
                              "chain_count_mismatch", "missing_checkpoint",
                              "table_shape_mismatch"])
def test_bad_checkpoint_rejected(tmp_path, make_ckpt):
    """A mislabelled manifest, another chain count, no checkpoint at all
    and tables of another shape than the served ones are each rejected
    before the swap, and the old epoch serves on."""
    step, reason = make_ckpt(tmp_path)
    svc = make_service()
    rep = svc.reload_from_checkpoint(str(tmp_path), step=step)
    assert not rep["ok"] and reason in rep["reason"]
    assert svc.stats()["model_epoch"] == 0
    assert svc.stats()["reloads_rejected"] == 1


def test_reload_quarantines_unhealthy_chains(tmp_path):
    """A checkpoint with one poisoned chain still swaps in, degraded: the
    bad chain is quarantined at screen time, survivors serve."""
    save_checkpoint(str(tmp_path), 2,
                    poison_model_table(MODELS_B, 0, "bad_rowsum"))
    svc = make_service()
    rep = svc.reload_from_checkpoint(str(tmp_path))
    assert rep["ok"] and rep["quarantined_chains"] == [0]
    st = svc.stats()
    assert st["alive_chains"] == M - 1
    rid = svc.submit(DOCS[0])
    svc.drain()
    assert np.isfinite(svc.result(rid).yhat)


def test_reload_all_chains_unhealthy_rejected(tmp_path):
    bad = MODELS_B
    for c in range(M):
        bad = poison_model_table(bad, c, "nan_phi")
    save_checkpoint(str(tmp_path), 6, bad)
    svc = make_service()
    rep = svc.reload_from_checkpoint(str(tmp_path))
    assert not rep["ok"] and rep["reason"] == "all_chains_unhealthy"
    rid = svc.submit(DOCS[0])
    svc.drain()
    assert np.isfinite(svc.result(rid).yhat)     # old model still serves


# ------------------------------------------------ deterministic overload

def _burst(seed=0, **kw):
    return burst_trace(seed, CFG.vocab_size, MAXLEN, **{
        **dict(base_rate=16.0, burst_rate=320.0, n_steady=24, n_burst=128,
               n_tail=24), **kw})


def test_burst_overload_admission_bounds_latency():
    """Open-loop burst replay on a virtual clock: with admission control
    and deadlines the served p99 stays near the deadline and overload is
    shed; without, everything is served with a worse tail."""
    d = 0.5                                      # seconds per dispatch
    deadline = 2.0
    trace = _burst()

    def run(**kw):
        clock = VirtualClock()
        svc = make_service(auto_flush=False, cache_results=False,
                           clock=clock, **kw)
        inject_dispatch_delay(svc, d)
        replay_open_loop(svc, trace, clock)
        lat = [r.latency_s for r in svc._results.values()
               if r.status == STATUS_OK]
        shed = sum(1 for r in svc._results.values()
                   if r.status != STATUS_OK)
        return np.percentile(lat, 99), shed / len(svc._results), svc

    p99_admit, shed_admit, svc_a = run(max_pending=2 * BATCH,
                                       default_deadline_s=deadline)
    p99_open, shed_open, _ = run()
    assert shed_open == 0.0                      # baseline serves all …
    assert p99_open > p99_admit                  # … with a worse tail
    assert p99_admit <= deadline + 2 * d         # bounded by policy
    assert shed_admit > 0.0                      # overload went somewhere
    st = svc_a.stats()
    assert st["expired"] + st["shed_queue_full"] > 0


def test_burst_replay_is_deterministic():
    trace = _burst(3, base_rate=8.0, burst_rate=64.0, n_steady=8,
                   n_burst=32, n_tail=8)
    outs = []
    for _ in range(2):
        clock = VirtualClock()
        svc = make_service(auto_flush=False, cache_results=False,
                           clock=clock, max_pending=BATCH,
                           default_deadline_s=1.0)
        inject_dispatch_delay(svc, 0.25)
        replay_open_loop(svc, trace, clock)
        outs.append({rid: (r.status, r.yhat) for rid, r in
                     svc._results.items()})
    assert outs[0].keys() == outs[1].keys()
    for rid in outs[0]:
        s0, y0 = outs[0][rid]
        s1, y1 = outs[1][rid]
        assert s0 == s1
        assert (y0 == y1) or (np.isnan(y0) and np.isnan(y1))


def test_burst_replay_statuses_match_reference():
    """The same burst trace (the reference's own `burst_trace`, equal bit
    for bit to the port's) on the same virtual clock through the
    reference's service and the port's: every request resolves to the
    same status (ok, shed or expired) at the same latency."""
    kw = dict(base_rate=16.0, burst_rate=320.0, n_steady=24, n_burst=128,
              n_tail=24)
    trace = _burst(**kw)
    j_trace = j_burst_trace(0, CFG.vocab_size, MAXLEN, **kw)
    assert len(trace) == len(j_trace)
    for (ta, da), (tb, db) in zip(trace, j_trace):
        assert ta == tb and np.array_equal(da, db)
    policy = dict(auto_flush=False, cache_results=False,
                  max_pending=2 * BATCH, default_deadline_s=2.0)
    jclock, pclock = JVirtualClock(), VirtualClock()
    jsvc = JService(J_MODELS, JConfig(**CFG_KW),
                    dataclasses.replace(SVC, **policy),
                    key=jax.random.PRNGKey(9), clock=jclock)
    psvc = make_service(clock=pclock, **policy)
    j_inject_dispatch_delay(jsvc, 0.5)
    inject_dispatch_delay(psvc, 0.5)
    j_arr = j_replay_open_loop(jsvc, j_trace, jclock)
    p_arr = replay_open_loop(psvc, trace, pclock)
    assert j_arr == p_arr
    statuses = [(jsvc.result(r).status, psvc.result(r).status)
                for r in p_arr]
    assert all(a == b for a, b in statuses)
    seen = {s for s, _ in statuses}
    assert STATUS_OK in seen and seen & {STATUS_EXPIRED, STATUS_SHED_QUEUE}
    for r in p_arr:
        assert jsvc.result(r).latency_s == psvc.result(r).latency_s
    for k in ("dispatches", "expired", "shed_queue_full", "dummy_slots"):
        assert jsvc.stats()[k] == psvc.stats()[k], k


# ------------------------------------------------------- observability

def test_stats_surface_robustness_counters():
    svc = make_service()
    st = svc.stats()
    for key in ("queue_depth", "shed_queue_full", "shed_rate_limit",
                "expired", "rejected_invalid", "dispatch_quarantines",
                "load_quarantines", "reloads_ok", "reloads_rejected",
                "model_epoch", "ckpt_step", "alive_chains",
                "chain_health", "drain_timeouts"):
        assert key in st
    assert st["model_epoch"] == 0 and st["alive_chains"] == M
    assert len(st["chain_health"]) == M
    assert all(h == [] for h in st["chain_health"])
    assert st["dispatch"] == "eager" and st["device"] == "cpu"


def test_describe_reports_robustness_policy():
    svc = make_service(max_pending=32, default_deadline_s=0.5,
                       rate_limit_per_s=100.0)
    rob = svc.describe()["robustness"]
    assert rob["max_pending"] == 32
    assert rob["default_deadline_s"] == 0.5
    assert rob["rate_limit_per_s"] == 100.0
    assert rob["robust_checks"] is True
    assert "earliest-deadline" in rob["scheduling"]


def test_service_refuses_the_card_without_one(monkeypatch):
    """The service runs on the card unless asked for the CPU: with no
    CUDA device it raises rather than serve on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLDAPredictionService(MODELS, CFG, SVC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SLDAPredictionService(MODELS, CFG, SVC, device="cuda")
